"""Train the restoration chain's learned-mask denoiser.

Counterpart of ``scripts/train_denoiser.py``: the same flags and defaults,
plus ``--device`` (``cuda`` unless ``cpu``). Clean clips come from the wavs
under ``--corpus`` (searched recursively, resampled to 22050 Hz, peak 0.6)
or, where it holds none, from 16 synthetic utterances:

    python -m lightningfastspeech2_tpu_torch.cli.train_denoiser --corpus corpus \\
        --steps 3000 --out denoiser.npz

The npz it writes is the JAX package's layout, which both packages load.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

SR = 22050


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="denoiser training (PyTorch / CUDA)")
    p.add_argument("--corpus", default="_campaign/corpus")
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--n_clips", type=int, default=64)
    p.add_argument("--out", default="lightningfastspeech2_tpu_torch/data/denoiser.npz")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    return p


def make_clean(rng: np.random.Generator, seconds: float = 3.0) -> np.ndarray:
    """A synthetic utterance: random phones from the synthetic bank, peak 0.6."""
    from lightningfastspeech2_tpu_torch.data.synthetic import synth_phone

    labels = ["AA1", "IY0", "UW1", "EH0", "N", "S"]
    parts, total = [], 0
    while total < int(seconds * SR):
        lab = labels[rng.integers(len(labels))]
        seg = synth_phone(lab, float(rng.uniform(0.08, 0.25)), SR, rng)
        parts.append(seg)
        total += len(seg)
    x = np.concatenate(parts)[: int(seconds * SR)].astype(np.float32)
    return 0.6 * x / np.max(np.abs(x))


def load_clips(corpus: Path, n_clips: int, rng: np.random.Generator) -> list:
    from lightningfastspeech2_tpu_torch.data import wav as wav_io

    clips = []
    if corpus.is_dir():
        paths = sorted(corpus.rglob("*.wav"))
        rng.shuffle(paths)
        for path in paths[:n_clips]:
            w, sr = wav_io.read(path)
            w = wav_io.resample(w.astype(np.float32), sr, SR)
            peak = np.max(np.abs(w))
            if peak > 0:
                clips.append(0.6 * w / peak)
    return clips


def main(argv=None) -> dict:
    """Trains and saves ``--out``; returns the number of clips and every
    step's loss."""
    args = build_parser().parse_args(argv)
    from lightningfastspeech2_tpu_torch.core.device import f32_convolutions, resolve_device
    from lightningfastspeech2_tpu_torch.synthesis.denoiser import save, train_denoiser

    f32_convolutions("32")
    device = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    clips = load_clips(Path(args.corpus), args.n_clips, rng)
    if not clips:
        print("no corpus wavs; using synthetic utterances")
        clips = [make_clean(rng) for _ in range(16)]
    print(f"{len(clips)} clean clips")
    losses: list = []
    net = train_denoiser(clips, steps=args.steps, batch=args.batch, seed=args.seed, verbose=True,
                         device=device, losses=losses)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    save(net, args.out)
    print(f"saved {args.out}")
    return {"clips": len(clips), "losses": losses}


if __name__ == "__main__":
    main()
