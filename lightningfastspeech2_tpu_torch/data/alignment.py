"""The port's own copy of ``lightningfastspeech2_tpu/data/alignment.py``.

Forced-alignment ingestion: TextGrid phones tier -> (phones, durations).

Same contract as the reference's converter
(reference ``litfass/dataset/audio_utils.py:36-91``):

- silence labels {"sil","sp","spn",""} become "sil",
- a gap between consecutive intervals inserts an extra "sil" covering it,
- leading silences are dropped (start_time starts at the first real phone),
- trailing silences are dropped (cut at the last real phone),
- durations are frame counts on the hop grid via round(t*sr/hop) deltas,
- the rounding error vs ceil(((end-start)*sr - 1)/hop) is folded into the
  last phone.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from lightningfastspeech2_tpu_torch.data.textgrid import Tier

SILENCE_LABELS = ("sil", "sp", "spn", "")


def tier_to_alignment(
    tier: Tier, sampling_rate: int, hop_length: int
) -> Tuple[List[str], List[int], float, float]:
    """Returns (phones, durations, start_time, end_time)."""

    def frames(t: float) -> int:
        return int(np.round(t * sampling_rate / hop_length))

    phones: List[str] = []
    durations: List[int] = []
    start_time = 0.0
    end_time = 0.0
    end_idx = 0

    for iv in tier.intervals:
        s, e, p = iv.start, iv.end, iv.text

        if s != end_time and phones:
            phones.append("sil")
            durations.append(frames(s) - frames(end_time))

        if not phones:
            if p in SILENCE_LABELS:
                continue
            start_time = s

        if p not in SILENCE_LABELS:
            phones.append(p)
            end_time = e
            end_idx = len(phones)
        else:
            phones.append("sil")
            end_time = e
        durations.append(frames(e) - frames(s))

    phones = phones[:end_idx]
    durations = durations[:end_idx]

    if phones:
        true_dur = int(np.ceil(((end_time - start_time) * sampling_rate - 1) / hop_length))
        diff = true_dur - sum(durations)
        if diff:
            durations[-1] += diff

    return phones, durations, start_time, end_time
