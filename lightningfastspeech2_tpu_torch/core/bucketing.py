"""The port's own copy of ``lightningfastspeech2_tpu/core/bucketing.py``.
The frame bucket changes outputs (CWT recompose normalizes over the whole
bucket), so both packages must bucket identically.

Static-shape bucketing: the XLA compilation contract.

Everything under jit is traced once per input shape; ragged utterances must
therefore be padded to a small, fixed set of bucket shapes. The reference
already fought this on TPU with ``pad_to_multiple_of=64``
(reference ``datasets.py:103,872-877``, ``fastdiff_variances.py:55``) but only
padded element 0 of each batch — here bucketing is uniform and explicit.

Buckets: phone lengths are rounded up to multiples of ``phone_step`` (16) and
frame lengths to multiples of ``frame_step`` (256), both capped at the config
maxima (32 s of audio -> <=2757 frames, ``datasets.py:83-85``). A batch is
padded to its largest member's bucket, so a full training run touches at most
``len(phone_buckets) x len(frame_buckets)`` compiled programs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np

PHONE_STEP = 16
FRAME_STEP = 256


def round_up(n: int, step: int) -> int:
    return int(-(-n // step) * step)


@dataclass(frozen=True)
class Bucketer:
    """Maps raw (n_phones, n_frames) to a static bucket shape."""

    max_phones: int = 512
    max_frames: int = 2816
    phone_step: int = PHONE_STEP
    frame_step: int = FRAME_STEP

    def phone_bucket(self, n: int) -> int:
        return min(round_up(max(n, 1), self.phone_step), self.max_phones)

    def frame_bucket(self, n: int) -> int:
        return min(round_up(max(n, 1), self.frame_step), self.max_frames)

    def bucket(self, n_phones: int, n_frames: int) -> Tuple[int, int]:
        return self.phone_bucket(n_phones), self.frame_bucket(n_frames)

    @property
    def phone_buckets(self) -> Tuple[int, ...]:
        return tuple(range(self.phone_step, self.max_phones + 1, self.phone_step))

    @property
    def frame_buckets(self) -> Tuple[int, ...]:
        return tuple(range(self.frame_step, self.max_frames + 1, self.frame_step))


def pad_to(x: np.ndarray, length: int, axis: int = 0, value=0) -> np.ndarray:
    """Pad (or truncate) ``x`` along ``axis`` to exactly ``length``."""
    cur = x.shape[axis]
    if cur == length:
        return x
    if cur > length:
        sl = [slice(None)] * x.ndim
        sl[axis] = slice(0, length)
        return x[tuple(sl)]
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, length - cur)
    return np.pad(x, widths, constant_values=value)


def pad_batch(arrays: Sequence[np.ndarray], length: int, value=0) -> np.ndarray:
    """Stack variable-length arrays into (B, length, ...) with padding."""
    return np.stack([pad_to(np.asarray(a), length, 0, value) for a in arrays])
