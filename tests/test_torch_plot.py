"""The port's dataset figures (utils/plotting.py ``plot_item``,
cli/plot.py) against the JAX package's: the CLI writes the JAX CLI's file
names on a ``make_corpus`` corpus, in a process where matplotlib and PIL
cannot be imported; in the image, the phone boundaries, the variance
curves and the prior markers sit where the JAX figure's formulas put them
on the pixel grid; the eval examples are drawn through ``plot_item`` with
the JAX titles; and the PNG writer round-trips RGB."""

import os
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

from lightningfastspeech2_tpu.cli import plot as jplot
from lightningfastspeech2_tpu_torch.data.synthetic import make_corpus
from lightningfastspeech2_tpu_torch.utils import plotting as tp
from tests.torch_port_helpers import torch_threads

ROOT = Path(__file__).resolve().parents[1]
FLAGS = ["--n", "3", "--variances", "pitch", "energy", "--variance_transforms", "cwt", "none",
         "--stat_entries", "4"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def _decode(data: bytes) -> np.ndarray:
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and data[12:16] == b"IHDR"
    w, h, depth, color = struct.unpack(">IIBB", data[16:26])
    assert depth == 8 and color in (0, 2)
    n = struct.unpack(">I", data[33:37])[0]
    assert data[37:41] == b"IDAT"
    ch = 3 if color == 2 else 1
    rows = np.frombuffer(zlib.decompress(data[41:41 + n]), np.uint8).reshape(h, w * ch + 1)
    assert not rows[:, 0].any()   # filter type 0 on every row
    return rows[:, 1:].reshape(h, w, ch) if ch == 3 else rows[:, 1:]


def test_png_bytes_round_trips_rgb_and_gray():
    g = np.random.default_rng(0)
    rgb = g.integers(0, 256, (7, 5, 3), dtype=np.uint8)
    gray = g.integers(0, 256, (4, 9), dtype=np.uint8)
    assert np.array_equal(_decode(tp.png_bytes(rgb)), rgb)
    assert np.array_equal(_decode(tp.png_bytes(gray)), gray)


def test_cli_writes_the_jax_clis_file_names(tmp_path):
    corpus = make_corpus(tmp_path / "corpus", n_speakers=2, n_utts=2, seed=5)
    jplot.main(["--target_path", str(corpus), "--output_path", str(tmp_path / "jax"), *FLAGS])
    # a process in which matplotlib and PIL cannot be imported
    code = ("import sys; sys.modules['matplotlib'] = None; sys.modules['PIL'] = None\n"
            "from lightningfastspeech2_tpu_torch.cli import plot\n"
            f"plot.main(sys.argv[1:])")
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    subprocess.run([sys.executable, "-c", code, "--target_path", str(corpus), "--output_path",
                    str(tmp_path / "port"), "--device", "cpu", *FLAGS],
                   check=True, cwd=tmp_path, env=env, capture_output=True)
    ours = sorted(p.name for p in (tmp_path / "port").glob("*.png"))
    assert ours == sorted(p.name for p in (tmp_path / "jax").glob("*.png"))
    assert len(ours) == 3
    for name in ours:
        img = _decode((tmp_path / "port" / name).read_bytes())
        # the mel, one CWT panel and the priors panel (pitch, energy, duration)
        geo = tp.item_layout(img.shape[1] // tp.FRAME_PX, 80, 2, phones=True)
        assert img.shape == (geo["height"], geo["width"], 3)


def _item(T=60, n_mels=20):
    g = np.random.default_rng(1)
    mel = g.standard_normal((T, n_mels))
    durations = np.array([7, 9, 5, 12, 8, 10, 9])
    phones = ["h", "ə", "l", "oʊ", "w", "ɝ", "d"]
    pitch = np.sin(np.arange(T) / 6.0) * 40 + 150
    return mel, durations, phones, pitch


def test_phone_boundaries_sit_at_the_duration_sums():
    mel, durations, phones, _ = _item()
    plain = tp.plot_item(mel)
    ticked = tp.plot_item(mel, durations=durations)
    geo = tp.item_layout(len(mel), mel.shape[1], 0, phones=False)
    band = slice(geo["mel_top"], geo["mel_top"] + geo["mel_h"])
    changed = np.nonzero((plain[band] != ticked[band]).any(axis=(0, 2)))[0]
    # JAX: axvline at each of cumsum(durations)[:-1], white at alpha 0.3
    want = np.cumsum(durations)[:-1] * tp.FRAME_PX
    assert changed.tolist() == want.tolist()
    x = want[0]
    np.testing.assert_array_equal(
        ticked[band][:, x], np.round(plain[band][:, x] * 0.7 + 255 * 0.3).astype(np.uint8))
    # labelled: a text strip above the mel, the mel shifted down by it
    labelled = tp.plot_item(mel, durations=durations, phones=phones)
    top = tp.item_layout(len(mel), mel.shape[1], 0, phones=True)["mel_top"]
    assert top == geo["mel_top"] + tp.LABEL_H
    np.testing.assert_array_equal(labelled[top:top + geo["mel_h"]], ticked[band])
    strip = labelled[tp.TITLE_H:top]
    assert (strip != 255).any()   # the phone labels are drawn


def test_variance_curves_sit_on_the_jax_scale():
    mel, _, _, pitch = _item()
    n_mels = mel.shape[1]
    curves = {"pitch": pitch, "energy": pitch[::-1] * 2}
    img = tp.plot_item(mel, variances=curves)
    top = tp.item_layout(len(mel), n_mels, 0, phones=False)["mel_top"]
    for i, curve in enumerate(curves.values()):
        # JAX: (curve - nanmin) / max(nanmax - nanmin, 1e-9) * (n_mels - 1)
        lo, hi = np.nanmin(curve), np.nanmax(curve)
        scaled = (curve - lo) / max(hi - lo, 1e-9) * (n_mels - 1)
        rows = top + np.round((n_mels - 1 - scaled) * tp.BIN_PX + (tp.BIN_PX - 1) / 2)
        cols = np.arange(len(curve)) * tp.FRAME_PX + tp.FRAME_PX // 2
        # alone, the curve is its colour at every frame
        alone = tp.plot_item(mel, variances={"c": curve})
        assert all(tuple(alone[int(r), c]) == tp.CYCLE[0] for r, c in zip(rows, cols))
        # beside the other, the later curve is drawn over the earlier where
        # they cross
        both = [tuple(img[int(r), c]) == tp.CYCLE[i] for r, c in zip(rows, cols)]
        assert all(both) if i == 1 else np.mean(both) > 0.8
    # the legend names each curve in its colour in the title strip
    assert (img[:tp.TITLE_H] == tp.CYCLE[0]).all(axis=-1).any()
    assert (img[:tp.TITLE_H] == tp.CYCLE[1]).all(axis=-1).any()


def test_cwt_and_prior_panels():
    mel, _, _, _ = _item()
    T, n_mels = mel.shape
    spec = np.random.default_rng(2).standard_normal((T, 10))
    priors = {"pitch": 0.7, "duration": -1.5}
    stats = {"pitch": {"mean": 0.0, "std": 1.0}, "duration": {"mean": 1.0, "std": 0.5}}
    img = tp.plot_item(mel, cwt_spectrograms={"pitch": spec}, priors=priors,
                       prior_stats=stats, title="spk0/utt1")
    geo = tp.item_layout(T, n_mels, 2, phones=False)
    assert img.shape == (geo["height"], geo["width"], 3)
    cwt_top, prior_top = geo["panel_tops"]
    h = geo["panel_h"]
    # the CWT panel: viridis over the spectrogram's own range, lowest scale at the bottom
    panel = img[cwt_top:cwt_top + h]
    viridis = {tuple(c) for c in tp.colormap(np.linspace(0, 1, 4097), tp.VIRIDIS)}
    assert all(tuple(p) in viridis for p in panel.reshape(-1, 3)[::97])
    lowest = tp.colormap(tp._normalized(spec)[:, 0], tp.VIRIDIS)
    np.testing.assert_array_equal(panel[-1, ::tp.FRAME_PX], lowest)
    # the priors: JAX's densities over mean +- 4 std; each marker a dashed
    # column at the value, on an x-axis spanning all of them
    lo = min(0.0 - 4.0, 0.7, 1.0 - 2.0, -1.5)
    hi = max(0.0 + 4.0, 0.7, 1.0 + 2.0, -1.5)
    W = geo["width"]
    for i, (name, value) in enumerate(priors.items()):
        col = int(round((value - lo) / (hi - lo) * (W - 1)))
        marks = (img[prior_top:prior_top + h, col] == tp.CYCLE[i]).all(axis=-1)
        assert 0.3 < marks.mean() < 0.7   # dashed: about half the rows
        # the density's peak, raised by the prior's index, at its mean
        mean = stats[name]["mean"]
        peak_col = int(round((mean - lo) / (hi - lo) * (W - 1)))
        peak_row = prior_top + int(round((2 - (1.0 + i)) / 2 * (h - 1)))
        assert tuple(img[peak_row, peak_col]) == tp.CYCLE[i]


def test_eval_examples_draw_through_plot_item(tmp_path):
    g = np.random.default_rng(3)
    pred, true = g.standard_normal((40, 80)), g.standard_normal((50, 80))
    tp.save_eval_examples(tmp_path, 7, [pred], [true])
    out = tmp_path / "step_00000007"
    assert sorted(p.name for p in out.iterdir()) == ["0_pred.png", "0_true.png"]
    for name, mel, title in (("0_pred.png", pred, "pred 0"), ("0_true.png", true, "true 0")):
        np.testing.assert_array_equal(_decode((out / name).read_bytes()),
                                      tp.plot_item(mel, title=title))
    img = _decode((out / "0_pred.png").read_bytes())
    title = np.full((tp.TITLE_H, img.shape[1], 3), 255, np.uint8)
    tp.draw_text(title, "pred 0", 2, 2, (0, 0, 0), scale=2)
    np.testing.assert_array_equal(img[:tp.TITLE_H], title)
    assert (img[:tp.TITLE_H] == 0).all(axis=-1).sum() > 20
