"""Dataset and eval figures: the composite item figure and the eval
examples on disk.

Counterpart of ``lightningfastspeech2_tpu/utils/plotting.py`` (the
reference's ``TTSDataset.plot``, ``litfass/dataset/datasets.py:888-1015``,
and its wandb example table, ``fastspeech2.py:900-944``). The JAX package
draws with matplotlib; the card's machine has neither matplotlib nor PIL,
so ``plot_item`` paints an RGB ``uint8`` array itself and ``png_bytes``
writes it with ``zlib`` and ``struct``. The panels are the JAX figure's, in
its order, on a fixed pixel grid (``FRAME_PX`` columns a frame, ``BIN_PX``
rows a mel bin):

- the title, and the variance curves' legend (each name in its colour);
- the phone labels above the mel, centred on their phones (every
  ``len(phones) // 40``-th, as the JAX figure thins them);
- the mel (magma, low bins at the bottom), a white line at 30 % over each
  phone boundary ``cumsum(durations)[:-1]``, and each variance curve
  scaled to the mel bins, ``(c - min) / (max - min) * (n_mels - 1)``;
- one panel a CWT spectrogram (viridis, scales stretched to the panel);
- the priors: per prior the normal density of its stats over mean ± 4
  std, scaled to peak 1 and raised by its index, with a dashed marker at
  its value, on an x-axis that spans them all.

Text is a built-in 3 x 5 bitmap font of A-Z (either case draws the
capitals), 0-9 and `` /_-.:``; phones are written in ARPAbet (the IPA the
corpus carries, mapped back), and any other character draws as a hatched
box. Axis ticks and axis titles are left out.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

from lightningfastspeech2_tpu_torch.data import wav as wav_io
from lightningfastspeech2_tpu_torch.data.vocab import ARPABET_TO_IPA

FRAME_PX = 2        # columns a frame (mel, CWT panels)
BIN_PX = 2          # rows a mel bin
TITLE_H = 14        # the title strip (text at twice the font's size)
LABEL_H = 8         # a strip of text at the font's size: phones, panel names
BOUNDARY_ALPHA = 0.3
# matplotlib's default colour cycle (tab10), which the JAX figure's curves take
CYCLE = ((31, 119, 180), (255, 127, 14), (44, 160, 44), (214, 39, 40), (148, 103, 189),
         (140, 86, 75), (227, 119, 194), (127, 127, 127), (188, 189, 34), (23, 190, 207))
# colour maps sampled at 0, 1/4, ..., 1 and interpolated linearly between
MAGMA = ((0, 0, 4), (81, 18, 124), (183, 55, 121), (252, 137, 97), (252, 253, 191))
VIRIDIS = ((68, 1, 84), (59, 82, 139), (33, 145, 140), (94, 201, 98), (253, 231, 37))
_IPA_TO_ARPABET = {v: k for k, v in ARPABET_TO_IPA.items()}

# the bitmap font: five rows of three cells a character
_GLYPHS = {
    "A": ".#. #.# ### #.# #.#", "B": "##. #.# ##. #.# ##.", "C": ".## #.. #.. #.. .##",
    "D": "##. #.# #.# #.# ##.", "E": "### #.. ##. #.. ###", "F": "### #.. ##. #.. #..",
    "G": ".## #.. #.# #.# .##", "H": "#.# #.# ### #.# #.#", "I": "### .#. .#. .#. ###",
    "J": "..# ..# ..# #.# .#.", "K": "#.# #.# ##. #.# #.#", "L": "#.. #.. #.. #.. ###",
    "M": "#.# ### ### #.# #.#", "N": "##. #.# #.# #.# #.#", "O": ".#. #.# #.# #.# .#.",
    "P": "##. #.# ##. #.. #..", "Q": ".#. #.# #.# ##. .##", "R": "##. #.# ##. #.# #.#",
    "S": ".## #.. .#. ..# ##.", "T": "### .#. .#. .#. .#.", "U": "#.# #.# #.# #.# ###",
    "V": "#.# #.# #.# #.# .#.", "W": "#.# #.# ### ### #.#", "X": "#.# #.# .#. #.# #.#",
    "Y": "#.# #.# .#. .#. .#.", "Z": "### ..# .#. #.. ###", "0": "### #.# #.# #.# ###",
    "1": ".#. ##. .#. .#. ###", "2": "##. ..# .#. #.. ###", "3": "##. ..# .#. ..# ##.",
    "4": "#.# #.# ### ..# ..#", "5": "### #.. ##. ..# ##.", "6": ".## #.. ### #.# ###",
    "7": "### ..# .#. .#. .#.", "8": "### #.# ### #.# ###", "9": "### #.# ### ..# ##.",
    " ": "... ... ... ... ...", "/": "..# ..# .#. #.. #..", "_": "... ... ... ... ###",
    "-": "... ... ### ... ...", ".": "... ... ... ... .#.", ":": "... .#. ... .#. ...",
}
_UNKNOWN = "#.# .#. #.# .#. #.#"


def _glyph(ch: str) -> np.ndarray:
    """A character's 5 x 3 bitmap."""
    rows = _GLYPHS.get(ch.upper(), _UNKNOWN).split()
    return np.array([[c == "#" for c in row] for row in rows])


def text_width(text: str, scale: int = 1) -> int:
    return 4 * scale * len(text)


def draw_text(img: np.ndarray, text: str, top: int, left: int, color, scale: int = 1) -> None:
    """``text`` in the bitmap font, its top left corner at (top, left), each
    glyph 3 x 5 cells of ``scale`` pixels and a cell of space after it;
    what falls outside the image is cut."""
    H, W = img.shape[:2]
    for i, ch in enumerate(text):
        cells = np.kron(_glyph(ch), np.ones((scale, scale), bool))
        y0, x0 = top, left + text_width(text[:i], scale)
        ys, xs = np.nonzero(cells)
        ys, xs = ys + y0, xs + x0
        keep = (ys >= 0) & (ys < H) & (xs >= 0) & (xs < W)
        img[ys[keep], xs[keep]] = color


def colormap(values: np.ndarray, stops) -> np.ndarray:
    """values in [0, 1] -> RGB uint8 through the stops, linearly."""
    stops = np.asarray(stops, np.float64)
    v = np.clip(np.nan_to_num(np.asarray(values, np.float64)), 0.0, 1.0) * (len(stops) - 1)
    i = np.minimum(v.astype(int), len(stops) - 2)
    f = (v - i)[..., None]
    return np.round(stops[i] * (1 - f) + stops[i + 1] * f).astype(np.uint8)


def _normalized(a: np.ndarray) -> np.ndarray:
    """imshow's autoscale: the array's own min and max to 0 and 1."""
    a = np.asarray(a, np.float64)
    lo, hi = np.nanmin(a), np.nanmax(a)
    return (a - lo) / max(hi - lo, 1e-12)


def draw_line(img: np.ndarray, ys, xs, color, dash: int = 0) -> None:
    """A polyline through the pixel points (ys[i], xs[i]), one pixel wide;
    ``dash`` > 0 draws ``dash`` pixels on, ``dash`` off. Points with a NaN
    break the line."""
    H, W = img.shape[:2]
    n = 0
    for (y0, x0), (y1, x1) in zip(zip(ys[:-1], xs[:-1]), zip(ys[1:], xs[1:])):
        if not np.isfinite([y0, x0, y1, x1]).all():
            continue
        steps = int(max(abs(y1 - y0), abs(x1 - x0))) + 1
        for t in np.linspace(0.0, 1.0, steps):
            y, x = int(round(y0 + (y1 - y0) * t)), int(round(x0 + (x1 - x0) * t))
            n += 1
            if dash and (n // dash) % 2:
                continue
            if 0 <= y < H and 0 <= x < W:
                img[y, x] = color


def item_layout(n_frames: int, n_mels: int, n_panels: int, phones: bool) -> Dict[str, object]:
    """Where ``plot_item`` draws: the image's height and width, the mel
    panel's top row (``mel_top``) and height, and each further panel's top
    row (``panel_tops``) and height (``panel_h``, a third of the mel's, as
    the JAX figure's height ratios 3 : 1)."""
    mel_h = n_mels * BIN_PX
    panel_h = max(mel_h // 3, 8)
    mel_top = TITLE_H + (LABEL_H if phones else 0)
    tops = [mel_top + mel_h + LABEL_H + i * (LABEL_H + panel_h) for i in range(n_panels)]
    return {"height": mel_top + mel_h + n_panels * (LABEL_H + panel_h),
            "width": n_frames * FRAME_PX, "mel_top": mel_top, "mel_h": mel_h,
            "panel_tops": tops, "panel_h": panel_h}


def curve_rows(curve: np.ndarray, n_mels: int, mel_top: int) -> np.ndarray:
    """A variance curve's rows on the mel panel: scaled to the mel bins as
    the JAX figure scales it, bin 0 at the bottom."""
    curve = np.asarray(curve, np.float64)
    lo, hi = np.nanmin(curve), np.nanmax(curve)
    scaled = (curve - lo) / max(hi - lo, 1e-9) * (n_mels - 1)
    return mel_top + np.round((n_mels - 1 - scaled) * BIN_PX + (BIN_PX - 1) / 2.0)


def prior_axis(priors: Dict[str, float], prior_stats: Dict[str, Dict[str, float]]):
    """(x range, [(name, xs, density scaled to peak 1, value)]) of the
    priors panel, as the JAX figure computes each density; the range spans
    every density and marker (matplotlib's autoscale)."""
    curves = []
    for name, value in priors.items():
        stats = (prior_stats or {}).get(name, {})
        mean = stats.get("mean", value)
        std = max(stats.get("std", 1.0), 1e-6)
        xs = np.linspace(mean - 4 * std, mean + 4 * std, 200)
        pdf = np.exp(-0.5 * ((xs - mean) / std) ** 2) / (std * np.sqrt(2 * np.pi))
        curves.append((name, xs, pdf / pdf.max(), float(value)))
    lo = min(min(xs[0], v) for _, xs, _, v in curves)
    hi = max(max(xs[-1], v) for _, xs, _, v in curves)
    return (lo, hi), curves


def prior_column(x: float, x_range, width: int) -> int:
    lo, hi = x_range
    return int(round((x - lo) / max(hi - lo, 1e-12) * (width - 1)))


def plot_item(
    mel: np.ndarray,                                            # (T, n_mels)
    durations: Optional[np.ndarray] = None,
    phones: Optional[Sequence[str]] = None,
    variances: Optional[Dict[str, np.ndarray]] = None,          # frame level
    cwt_spectrograms: Optional[Dict[str, np.ndarray]] = None,   # (T, scales)
    priors: Optional[Dict[str, float]] = None,
    prior_stats: Optional[Dict[str, Dict[str, float]]] = None,
    title: str = "",
) -> np.ndarray:
    """The composite figure of one item as an (H, W, 3) uint8 RGB image
    (``item_layout`` gives its geometry); ``png_bytes`` writes it."""
    mel = np.asarray(mel, np.float64)
    T, n_mels = mel.shape
    variances = variances or {}
    cwt_spectrograms = cwt_spectrograms or {}
    priors = priors or {}
    labelled = durations is not None and phones is not None
    geo = item_layout(T, n_mels, len(cwt_spectrograms) + (1 if priors else 0), labelled)
    img = np.full((geo["height"], geo["width"], 3), 255, np.uint8)
    top, mel_h, W = geo["mel_top"], geo["mel_h"], geo["width"]

    draw_text(img, title, 2, 2, (0, 0, 0), scale=2)
    right = W - 2
    for i, name in reversed(list(enumerate(variances))):
        right -= text_width(name) + 4
        draw_text(img, name, 4, right, CYCLE[i % len(CYCLE)])

    # the mel, low bins at the bottom, each frame FRAME_PX columns wide
    rgb = colormap(_normalized(mel.T[::-1]), MAGMA)
    img[top:top + mel_h] = np.repeat(np.repeat(rgb, BIN_PX, 0), FRAME_PX, 1)

    if durations is not None:
        durations = np.asarray(durations)
        bounds = np.cumsum(durations)
        for b in bounds[:-1]:
            x = int(b) * FRAME_PX
            if 0 <= x < W:
                band = img[top:top + mel_h, x].astype(np.float64)
                img[top:top + mel_h, x] = np.round(
                    band * (1 - BOUNDARY_ALPHA) + 255.0 * BOUNDARY_ALPHA).astype(np.uint8)
        if phones is not None:
            centers = bounds - durations / 2
            step = max(len(phones) // 40, 1)   # as the JAX figure: no label soup
            for i in range(0, len(phones), step):
                label = _IPA_TO_ARPABET.get(phones[i], phones[i])
                x = int(round(centers[i] * FRAME_PX)) - text_width(label) // 2
                draw_text(img, label, TITLE_H + 1, x, (0, 0, 0))

    for i, (name, curve) in enumerate(variances.items()):
        curve = np.asarray(curve, np.float64)[:T]
        xs = np.arange(len(curve)) * FRAME_PX + FRAME_PX // 2
        draw_line(img, curve_rows(curve, n_mels, top), xs, CYCLE[i % len(CYCLE)])

    panel_h = geo["panel_h"]
    tops = iter(geo["panel_tops"])
    for name, spec in cwt_spectrograms.items():
        y0 = next(tops)
        draw_text(img, f"{name} cwt", y0 - LABEL_H + 1, 2, (0, 0, 0))
        spec = np.asarray(spec, np.float64)[:T]
        rows = (panel_h - 1 - np.arange(panel_h)) * spec.shape[1] // panel_h
        panel = colormap(_normalized(spec.T[rows]), VIRIDIS)
        img[y0:y0 + panel_h, :spec.shape[0] * FRAME_PX] = np.repeat(panel, FRAME_PX, 1)

    if priors:
        y0 = next(tops)
        draw_text(img, "priors", y0 - LABEL_H + 1, 2, (0, 0, 0))
        x_range, curves = prior_axis(priors, prior_stats)
        n = len(curves)
        for i, (name, xs, density, value) in enumerate(curves):
            color = CYCLE[i % len(CYCLE)]
            cols = [prior_column(x, x_range, W) for x in xs]
            rows = y0 + np.round((n - (density + i)) / n * (panel_h - 1))
            draw_line(img, rows, cols, color)
            x = prior_column(value, x_range, W)
            draw_line(img, [y0, y0 + panel_h - 1], [x, x], color, dash=4)
            draw_text(img, name, y0 + 1 + 6 * i, W - 2 - text_width(name), color)
    return img


def png_bytes(image: np.ndarray) -> bytes:
    """An (H, W) grayscale or (H, W, 3) RGB uint8 array as a PNG (one IDAT,
    no filter)."""
    image = np.ascontiguousarray(image, np.uint8)
    h, w = image.shape[:2]
    color_type = 2 if image.ndim == 3 else 0

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    rows = np.concatenate([np.zeros((h, 1), np.uint8), image.reshape(h, -1)], axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def save_eval_examples(out_dir, step: int, mels_pred: Sequence[np.ndarray],
                       mels_true: Sequence[np.ndarray],
                       audios: Optional[Sequence[np.ndarray]] = None,
                       sampling_rate: int = 22050, max_examples: int = 10) -> None:
    """``<out_dir>/step_XXXXXXXX/{i}_pred.png``, ``{i}_true.png`` (each mel
    through ``plot_item``, titled ``pred {i}`` / ``true {i}``) and, with
    ``audios``, ``{i}_pred.wav``."""
    out = Path(out_dir) / f"step_{step:08d}"
    out.mkdir(parents=True, exist_ok=True)
    for i, (p, t) in enumerate(zip(mels_pred, mels_true)):
        if i >= max_examples:
            break
        (out / f"{i}_pred.png").write_bytes(png_bytes(plot_item(p, title=f"pred {i}")))
        (out / f"{i}_true.png").write_bytes(png_bytes(plot_item(t, title=f"true {i}")))
        if audios is not None and i < len(audios):
            wav_io.write(out / f"{i}_pred.wav", audios[i], sampling_rate)
