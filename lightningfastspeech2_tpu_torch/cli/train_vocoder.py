"""HiFi-GAN vocoder training / fine-tuning CLI.

Counterpart of ``lightningfastspeech2_tpu/cli/train_vocoder.py`` (its
flags and defaults: HiFi-GAN V1 and the upstream ``config.json``), on
``cuda`` unless ``--device cpu``:

    python -m lightningfastspeech2_tpu_torch.cli.train_vocoder \\
        --train_target_path corpus --checkpoint_dir voc_ckpts --max_steps 100000

Every step draws ``batch_size`` random segments of ``segment_size``
samples from the wav corpus (``SegmentSampler``), computes their
conditioning log-mel on the device with the port's front end
(``audio/mel.py``, the acoustic model's mel) and runs one discriminator
and one generator update (``vocoder/hifigan_train.py HifiGanTrainer``), in
f32 with TF32 off (``core/device.py f32_convolutions``), as the JAX
trainer computes it.

Warm starts: ``--from_torch_hifigan`` (a released torch generator
checkpoint, weight norm folded by ``vocoder/hifigan.py
load_torch_generator``) or ``--from_checkpoint`` (a directory this CLI
wrote: weights, both optimizers and the step). Checkpoints
(``core/checkpoint.py``, written in the background) hold ``params {"gen",
"disc"}``, ``opt_state {"gen", "disc"}`` (the optimizers' ``state_dict()``)
and ``step``, the generator's architecture in the sidecar's
``hifigan_config``; ``cli/generate.py --hifigan_checkpoint`` serves the
directory. A directory the JAX CLI wrote converts its generator only
(``scripts/jax_checkpoint_to_torch.py``; ROADMAP A).
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path
from typing import List

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="HiFi-GAN training on the card")
    p.add_argument("--train_target_path", type=str, required=True,
                   help="directory of .wav files (searched recursively)")
    p.add_argument("--checkpoint_dir", type=str, default="vocoder_checkpoints")
    p.add_argument("--log_dir", type=str, default=None)
    p.add_argument("--batch_size", type=int, default=16,
                   help="upstream config.json batch_size")
    p.add_argument("--segment_size", type=int, default=8192)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--adam_b1", type=float, default=0.8)
    p.add_argument("--adam_b2", type=float, default=0.99)
    p.add_argument("--lr_decay", type=float, default=0.999)
    p.add_argument("--mel_weight", type=float, default=45.0)
    p.add_argument("--fm_weight", type=float, default=2.0)
    p.add_argument("--max_steps", type=int, default=100000)
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--checkpoint_every", type=int, default=5000)
    p.add_argument("--seed", type=int, default=42)
    # generator architecture (defaults = HiFi-GAN V1 / config.json)
    p.add_argument("--upsample_rates", nargs="+", type=int, default=[8, 8, 2, 2])
    p.add_argument("--upsample_kernel_sizes", nargs="+", type=int, default=[16, 16, 4, 4])
    p.add_argument("--upsample_initial_channel", type=int, default=512)
    p.add_argument("--resblock_kernel_sizes", nargs="+", type=int, default=[3, 7, 11])
    p.add_argument("--from_torch_hifigan", type=str, default=None,
                   help="torch generator checkpoint to fine-tune from")
    p.add_argument("--from_checkpoint", type=str, default=None,
                   help="checkpoint dir of a previous run to resume")
    p.add_argument("--wandb_mode", type=str, default="offline")
    p.add_argument("--wandb_project", type=str, default="lfs2_tpu_vocoder")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="where the trainer runs (the CPU runs the plain path)")
    return p


class SegmentSampler:
    """Random fixed-length waveform segments from a wav corpus, as numpy
    (the JAX CLI's sampler, draw for draw).

    Files are loaded lazily, resampled to ``sr`` and peak-normalised, and
    kept in an in-memory cache of at most ``cache_files`` (FIFO). Short
    files are zero-padded to one segment."""

    def __init__(self, root: Path, sr: int, segment_size: int, seed: int = 0,
                 cache_files: int = 4096):
        from lightningfastspeech2_tpu_torch.data import wav as wav_io

        self._read, self._resample = wav_io.read, wav_io.resample
        self.paths: List[Path] = sorted(Path(root).rglob("*.wav"))
        if not self.paths:
            raise SystemExit(f"no .wav files under {root}")
        self.sr, self.segment_size = sr, segment_size
        self.rng = np.random.default_rng(seed)
        self.cache_files = cache_files
        self._cache: dict = {}

    def _load(self, path: Path) -> np.ndarray:
        wav = self._cache.get(path)
        if wav is None:
            raw, file_sr = self._read(path)
            wav = self._resample(raw.astype(np.float32), file_sr, self.sr)
            peak = np.max(np.abs(wav))
            if peak > 0:
                wav = wav / peak  # load-time peak norm (datasets.py:369)
            if len(self._cache) >= self.cache_files:
                self._cache.pop(next(iter(self._cache)))
            self._cache[path] = wav
        return wav

    def batch(self, batch_size: int) -> np.ndarray:
        seg = self.segment_size
        out = np.zeros((batch_size, seg), np.float32)
        picks = self.rng.integers(0, len(self.paths), batch_size)
        for row, pi in enumerate(picks):
            wav = self._load(self.paths[int(pi)])
            if len(wav) <= seg:
                out[row, : len(wav)] = wav
            else:
                start = int(self.rng.integers(0, len(wav) - seg))
                out[row] = wav[start : start + seg]
        return out


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    import torch

    from lightningfastspeech2_tpu_torch.audio.mel import mel_spectrogram
    from lightningfastspeech2_tpu_torch.core.checkpoint import Checkpointer
    from lightningfastspeech2_tpu_torch.core.config import AudioConfig
    from lightningfastspeech2_tpu_torch.core.device import f32_convolutions, resolve_device
    from lightningfastspeech2_tpu_torch.train.metrics_logger import MetricsLogger
    from lightningfastspeech2_tpu_torch.vocoder import hifigan as hg
    from lightningfastspeech2_tpu_torch.vocoder.hifigan_train import (
        HifiGanTrainConfig,
        HifiGanTrainer,
    )

    f32_convolutions(32)   # the JAX trainer runs in f32; TF32 would not be that
    device = resolve_device(args.device)
    gen_cfg = hg.HifiGanConfig(
        upsample_rates=tuple(args.upsample_rates),
        upsample_kernel_sizes=tuple(args.upsample_kernel_sizes),
        upsample_initial_channel=args.upsample_initial_channel,
        resblock_kernel_sizes=tuple(args.resblock_kernel_sizes),
        resblock_dilation_sizes=((1, 3, 5),) * len(args.resblock_kernel_sizes),
    )
    # the conditioning mel lives on the generator's hop grid
    # (frames * hop == segment samples)
    audio_cfg = AudioConfig(hop_length=gen_cfg.hop_length)
    tcfg = HifiGanTrainConfig(
        lr=args.lr, adam_b1=args.adam_b1, adam_b2=args.adam_b2,
        lr_decay=args.lr_decay, mel_weight=args.mel_weight,
        fm_weight=args.fm_weight,
    )
    trainer = HifiGanTrainer(gen_cfg, tcfg, audio_cfg, device=device, seed=args.seed)

    start_step = 0
    if args.from_torch_hifigan:
        trainer.generator.load_state_dict(
            hg.load_torch_generator(args.from_torch_hifigan, gen_cfg))
        print(f"warm-started generator from {args.from_torch_hifigan}")
    elif args.from_checkpoint:
        tree, _, _ = Checkpointer(args.from_checkpoint).restore()
        trainer.load(tree["params"], tree.get("opt_state"))
        start_step = int(tree["step"])
        print(f"resumed from {args.from_checkpoint} at step {start_step}")

    # the resume step folds into the sampler's seed, so a resumed run draws
    # a fresh continuation of the segment stream instead of replaying it
    sampler = SegmentSampler(Path(args.train_target_path), audio_cfg.sampling_rate,
                             args.segment_size, seed=args.seed + start_step)
    print(f"{len(sampler.paths)} wav files", flush=True)
    seg_mel = args.segment_size // gen_cfg.hop_length

    def wav_to_mel(wav: torch.Tensor) -> torch.Tensor:
        # the front end gives 1 + N // hop frames; the generator's contract
        # is N // hop (frames * hop == segment samples): drop the last one
        return mel_spectrogram(wav, audio_cfg)[:, :seg_mel]

    # async: the step does not wait for the disk (``latest`` advances once
    # a write is complete)
    ckptr = Checkpointer(args.checkpoint_dir, use_async=True)
    logger = MetricsLogger(args.log_dir, use_wandb=args.wandb_mode == "online",
                           wandb_project=args.wandb_project)
    t_last = time.perf_counter()
    last_log_step = start_step
    for step in range(start_step, args.max_steps):
        wav = torch.from_numpy(sampler.batch(args.batch_size)).to(device)
        metrics = trainer.train_step(wav_to_mel(wav), wav)
        if step % args.log_every == 0 or step == args.max_steps - 1:
            # device scalars, read only here
            metrics = {k: float(v) for k, v in metrics.items()}
            now = time.perf_counter()
            done = step - last_log_step
            metrics["steps_per_s"] = done / (now - t_last) if done else 0.0
            t_last, last_log_step = now, step
            logger.log(step, {f"train/{k}": v for k, v in metrics.items()})
        if (step and step % args.checkpoint_every == 0) or step == args.max_steps - 1:
            # the generator's architecture rides in the sidecar, so that the
            # generate CLI rebuilds the module from the directory alone
            ckptr.save(step + 1, trainer.params(),
                       sidecar={"hifigan_config": dataclasses.asdict(gen_cfg)},
                       opt_state=trainer.opt_state())
            print(f"checkpointed step {step + 1} -> {args.checkpoint_dir}", flush=True)
    ckptr.wait_until_finished()
    logger.close()


if __name__ == "__main__":
    main()
