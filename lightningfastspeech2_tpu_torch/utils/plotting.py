"""Eval examples on disk: pred/true mel images and vocoded wavs.

Counterpart of ``save_eval_examples`` in
``lightningfastspeech2_tpu/utils/plotting.py`` (the reference's wandb
example table, ``fastspeech2.py:900-944``). The JAX package draws each mel
with matplotlib; the card's machine has neither matplotlib nor PIL, so here
each mel is written as an 8-bit grayscale PNG (frames left to right, mel
bins bottom to top, the mel's own range stretched to 0-255) by a small
writer on ``zlib`` and ``struct``. The composite ``plot_item`` figure is not
ported.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from lightningfastspeech2_tpu_torch.data import wav as wav_io


def png_bytes(image: np.ndarray) -> bytes:
    """An (H, W) uint8 array as a grayscale PNG (one IDAT, no filter)."""
    image = np.ascontiguousarray(image, np.uint8)
    h, w = image.shape

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    rows = np.concatenate([np.zeros((h, 1), np.uint8), image], axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def mel_image(mel: np.ndarray) -> np.ndarray:
    """(T, n_mels) -> (n_mels, T) uint8, low bins at the bottom."""
    m = np.asarray(mel, np.float64).T[::-1]
    lo, hi = float(np.min(m)), float(np.max(m))
    return np.round((m - lo) / max(hi - lo, 1e-9) * 255.0).astype(np.uint8)


def save_eval_examples(out_dir, step: int, mels_pred: Sequence[np.ndarray],
                       mels_true: Sequence[np.ndarray],
                       audios: Optional[Sequence[np.ndarray]] = None,
                       sampling_rate: int = 22050, max_examples: int = 10) -> None:
    """``<out_dir>/step_XXXXXXXX/{i}_pred.png``, ``{i}_true.png`` and, with
    ``audios``, ``{i}_pred.wav``."""
    out = Path(out_dir) / f"step_{step:08d}"
    out.mkdir(parents=True, exist_ok=True)
    for i, (p, t) in enumerate(zip(mels_pred, mels_true)):
        if i >= max_examples:
            break
        (out / f"{i}_pred.png").write_bytes(png_bytes(mel_image(p)))
        (out / f"{i}_true.png").write_bytes(png_bytes(mel_image(t)))
        if audios is not None and i < len(audios):
            wav_io.write(out / f"{i}_pred.wav", audios[i], sampling_rate)
