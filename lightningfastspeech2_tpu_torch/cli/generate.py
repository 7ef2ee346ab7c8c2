"""Synthesis CLI: a sentence -> wav, or a whole corpus re-synthesized, from
a checkpoint directory.

Counterpart of ``lightningfastspeech2_tpu/cli/generate.py`` (its parser,
sentence mode and ``--dataset`` mode), on ``cuda`` unless ``--device cpu``:

    python -m lightningfastspeech2_tpu_torch.cli.generate \\
        --checkpoint_dir ckpts --sentence "Hello world." --output_path out
    python -m lightningfastspeech2_tpu_torch.cli.generate \\
        --checkpoint_dir ckpts --dataset corpus --hours 0.5 --output_path out

``--dataset`` reads an aligned corpus (``<speaker>/<utt>.wav`` beside
``<utt>.TextGrid``) through ``data/dataset.py`` on the acoustic model's
device, serves each utterance's phones, speaker and priors, and writes
``<speaker>/<utt>.wav``, ``<utt>_original.wav``, ``<utt>.lab`` (the words)
and ``<utt>.meta`` (pickled phones and durations) until ``--hours`` of
audio are written.

The checkpoint directory is this package's (``core/checkpoint.py``;
``scripts/jax_checkpoint_to_torch.py`` converts a JAX one), with
``prior_gmms.pkl`` and ``dvector_gmms.pkl`` beside it as the JAX trainer
writes them. ``--tts_device`` and ``--vocoder_device`` are CUDA ordinals.
The acoustic model serves in f32; ``--vocoder_precision 16`` runs the
vocoder (HiFi-GAN or FastDiff) in bf16. Not ported: ``--hub`` (a
download, which needs the network and ``huggingface_hub``).
"""

from __future__ import annotations

import argparse
import pickle
import shutil
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch


def str2bool(v):
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("boolean value expected")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="FastSpeech2 synthesis (PyTorch / CUDA)")
    p.add_argument("--checkpoint_dir", type=str, default=None)
    p.add_argument("--hub", type=str, default=None,
                   help="HuggingFace Hub repo id (not ported: needs the network)")
    p.add_argument("--checkpoint_step", type=str, default=None)
    p.add_argument("--output_path", type=str, default="generated")
    p.add_argument("--sentence", type=str, default=None)
    p.add_argument("--speaker", type=str, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--prior_strategy", type=str, default="sample",
                   choices=["sample", "gmm"])
    p.add_argument("--sample_dvector", action="store_true",
                   help="draw a novel d-vector from the speaker's GMM "
                        "(needs dvector_gmms.pkl)")
    p.add_argument("--prior_values", nargs="*", type=float, default=[])
    p.add_argument("--lexicon_path", type=str, default="builtin",
                   help="CMUdict-format lexicon; 'builtin' = the shipped "
                        "expanded English lexicon, 'none' disables")
    p.add_argument("--g2p_model", type=str, default="builtin",
                   help="NeuralG2P .npz used for OOV words; 'builtin' = the "
                        "shipped data/g2p_en.npz, 'none' = rule LTS only")
    p.add_argument("--dataset", type=str, default=None,
                   help="aligned corpus root for re-synthesis mode")
    p.add_argument("--hours", type=float, default=1.0)
    p.add_argument("--hifigan_checkpoint", type=str, default=None,
                   help="a torch HiFi-GAN generator file (.pth.tar) or a "
                        "vocoder checkpoint directory of this package")
    p.add_argument("--no_vocoder", action="store_true")
    p.add_argument("--vocoder_precision", type=int, default=32, choices=[16, 32],
                   help="16 runs the vocoder (HiFi-GAN or FastDiff) in bf16")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="cuda (the kernels) or cpu (their plain versions)")
    p.add_argument("--tts_device", type=int, default=None,
                   help="CUDA ordinal for the acoustic model and the G2P")
    p.add_argument("--vocoder_device", type=int, default=None,
                   help="CUDA ordinal for the vocoder and the restorer")
    p.add_argument("--use_fastdiff", type=str2bool, default=False,
                   help="vocode with the checkpoint's jointly trained FastDiff")
    p.add_argument("--fastdiff_n", type=int, default=None,
                   help="reverse-diffusion steps (default: checkpoint cfg)")
    p.add_argument("--vocoder_fast_gating", type=str2bool, default=False,
                   help="Padé sigmoid/tanh in the FastDiff LVC gates")
    p.add_argument("--restore", type=str2bool, default=False,
                   help="post-vocoder restoration to 44.1 kHz (declip, "
                        "denoise, band-limited upsample, band replication)")
    p.add_argument("--augment_pitch_shift", type=str2bool, default=False)
    p.add_argument("--augment_pitch_shift_min_semitones", type=float, default=-1.0)
    p.add_argument("--augment_pitch_shift_max_semitones", type=float, default=1.0)
    p.add_argument("--augment_gaussian_snr", type=str2bool, default=False)
    p.add_argument("--augment_gaussian_snr_min_snr_db", type=float, default=15.0)
    p.add_argument("--augment_gaussian_snr_max_snr_db", type=float, default=30.0)
    p.add_argument("--augment_room", type=str2bool, default=False)
    return p


def _device(args, ordinal: Optional[int]) -> str:
    if args.device == "cpu":
        if ordinal is not None:
            raise ValueError("--tts_device / --vocoder_device are CUDA ordinals; "
                             "drop them with --device cpu")
        return "cpu"
    return "cuda" if ordinal is None else f"cuda:{ordinal}"


def load_generator(args):
    """(SpeechGenerator, Config, sidecar) from the parsed arguments."""
    from lightningfastspeech2_tpu_torch.core import config as C
    from lightningfastspeech2_tpu_torch.core.checkpoint import Checkpointer
    from lightningfastspeech2_tpu_torch.data.vocab import Vocab
    from lightningfastspeech2_tpu_torch.models.fastspeech2 import build_fastspeech2
    from lightningfastspeech2_tpu_torch.models.variance_adaptor import VarianceStats
    from lightningfastspeech2_tpu_torch.synthesis import neural_g2p
    from lightningfastspeech2_tpu_torch.synthesis.g2p import BUILTIN_LEXICON, EnglishG2P
    from lightningfastspeech2_tpu_torch.synthesis.generator import (
        FastDiffSynthesiser,
        SpeechGenerator,
    )
    from lightningfastspeech2_tpu_torch.utils.log_gmm import load_gmms
    from lightningfastspeech2_tpu_torch.vocoder import hifigan as hg

    if args.hub and not args.checkpoint_dir:
        raise NotImplementedError(
            "--hub downloads a checkpoint, which needs the network and "
            "huggingface_hub (ROADMAP.md A8: not portable offline); pass "
            "--checkpoint_dir")
    if not args.checkpoint_dir:
        raise ValueError("provide --checkpoint_dir")
    tts_dev = _device(args, args.tts_device)
    voc_dev = _device(args, args.vocoder_device)

    ckpt_dir = Path(args.checkpoint_dir)
    path = None
    if args.checkpoint_step:
        path = ckpt_dir / f"step_{int(args.checkpoint_step):08d}"
    tree, cfg, sidecar = Checkpointer(ckpt_dir).restore(path)
    if cfg is None:
        raise ValueError("checkpoint has no config.json")

    vocab = Vocab.from_dict(sidecar.get("phone2id", {"[PAD]": 0}))
    stats = sidecar.get("stats") or {}
    stats_tree = tuple((v, VarianceStats(**stats[v]))
                       for v in cfg.model.variance.variances if v in stats)
    prior_stats = tuple((p, VarianceStats(**stats[f"priors_{p}"]))
                        for p in cfg.model.priors if f"priors_{p}" in stats)
    mcfg = C.replace(cfg.model, vocab_size=max(len(vocab), 2))
    acoustic = tree["params"]
    fastdiff_params = None
    joint = mcfg.fastdiff_vocoder and "acoustic" in acoustic
    if joint:  # {"acoustic": ..., "fastdiff": ...}
        acoustic, fastdiff_params = acoustic["acoustic"], acoustic.get("fastdiff")
    model = build_fastspeech2(mcfg, device=tts_dev, state_dict=acoustic, stats=stats_tree,
                              prior_stats=prior_stats, use_fastdiff_head=joint)

    synthesiser = None
    if args.use_fastdiff:
        if fastdiff_params is None:
            raise ValueError("--use_fastdiff needs a joint checkpoint (trained with "
                             "--fastdiff_vocoder true)")
        synthesiser = FastDiffSynthesiser(
            C.replace(mcfg, fastdiff_inference_steps=args.fastdiff_n
                      or mcfg.fastdiff_inference_steps),
            state_dict=fastdiff_params, vocoder_precision=args.vocoder_precision,
            fast_gating=args.vocoder_fast_gating, device=voc_dev)
    elif not args.no_vocoder:
        voc_cfg, state = hg.HifiGanConfig(), None
        if args.hifigan_checkpoint:
            hc = Path(args.hifigan_checkpoint)
            if hc.is_dir():
                # own names: the acoustic tree and sidecar stay as they are
                voc_tree, _, voc_sidecar = Checkpointer(hc).restore()
                gc = (voc_sidecar or {}).get("hifigan_config")
                if gc:
                    voc_cfg = hg.HifiGanConfig.from_dict(gc)
                state = voc_tree["params"]["gen"]
            else:
                state = hg.load_torch_generator(hc, voc_cfg)
        synthesiser = hg.Synthesiser(
            voc_cfg, state_dict=state, device=voc_dev,
            dtype=torch.bfloat16 if args.vocoder_precision == 16 else torch.float32)

    gmms = {}
    for name in ("prior_gmms", "dvector_gmms"):
        p = ckpt_dir / f"{name}.pkl"
        gmms[name] = load_gmms(p) if p.exists() else None

    lexicon_path = args.lexicon_path
    if lexicon_path == "builtin":
        lexicon_path = BUILTIN_LEXICON if Path(BUILTIN_LEXICON).exists() else None
    elif lexicon_path in ("none", ""):
        lexicon_path = None
    g2p_model = args.g2p_model
    if g2p_model == "builtin":
        g2p_model = neural_g2p.BUILTIN_PATH if neural_g2p.BUILTIN_PATH.exists() else None
    elif g2p_model in ("none", ""):
        g2p_model = None
    neural = neural_g2p.NeuralG2P.load(g2p_model, device=tts_dev) if g2p_model else None

    gen = SpeechGenerator(
        C.replace(cfg, model=mcfg), model, vocab, EnglishG2P(lexicon_path, neural=neural),
        synthesiser=synthesiser,
        speaker2dvector=sidecar.get("speaker2dvector"),
        speaker2id=sidecar.get("speaker2id"),
        speaker2priors=sidecar.get("speaker2priors"),
        speaker_gmms=gmms["prior_gmms"],
        dvector_gmms=gmms["dvector_gmms"],
    )
    return gen, cfg, sidecar


def postprocess_chain(args):
    """The restorer and augmentations the flags ask for (restore first, then
    augment at the restored rate), or None."""
    restorer = augment = None
    if args.restore:
        from lightningfastspeech2_tpu_torch.synthesis.restore import AudioRestorer

        restorer = AudioRestorer(device=_device(args, args.vocoder_device))
    if args.augment_pitch_shift or args.augment_gaussian_snr or args.augment_room:
        from lightningfastspeech2_tpu_torch.synthesis.augment import from_args

        augment = from_args(
            pitch_shift=args.augment_pitch_shift,
            gaussian_snr=args.augment_gaussian_snr,
            room=args.augment_room,
            seed=args.seed,
            pitch_shift_min_semitones=args.augment_pitch_shift_min_semitones,
            pitch_shift_max_semitones=args.augment_pitch_shift_max_semitones,
            gaussian_snr_min_snr_db=args.augment_gaussian_snr_min_snr_db,
            gaussian_snr_max_snr_db=args.augment_gaussian_snr_max_snr_db,
            # explicit opt-in via flag -> always applied
            pitch_shift_p=1.0, gaussian_snr_p=1.0, room_p=1.0,
        )
    if restorer is None and augment is None:
        return None
    from lightningfastspeech2_tpu_torch.synthesis.generator import PostProcessChain

    return PostProcessChain(restorer, augment)


def synthesize_sentence(gen, cfg, args) -> np.ndarray:
    """The float waveform of ``args.sentence``, as sentence mode makes it."""
    prior_values = {p: (args.prior_values[i] if i < len(args.prior_values) else -1)
                    for i, p in enumerate(cfg.model.priors)}
    return gen.generate_from_text(
        args.sentence, speaker=args.speaker, seed=args.seed,
        prior_strategy=args.prior_strategy, prior_values=prior_values,
        sample_dvector=args.sample_dvector)


def resynthesize_dataset(gen, cfg, sidecar, args) -> Dict[str, np.ndarray]:
    """``--dataset`` mode: every utterance of the corpus, one at a time,
    through ``gen.generate_samples`` until ``--hours`` of audio are written.
    Features are extracted on the acoustic model's device with the
    checkpoint's variances, stats and d-vectors, and no duration
    augmentation. Returns the float waveforms written (before the int16
    write), keyed ``<speaker>/<utt>``."""
    from lightningfastspeech2_tpu_torch.data.dataset import DataConfig, TTSDataset

    m = cfg.model
    dcfg = DataConfig(
        variances=m.variance.variances,
        variance_levels=m.variance.levels,
        variance_transforms=m.variance.transforms,
        priors=m.priors,
        speaker_type=m.speaker_type,
        augment_duration=0.0,
        max_phones=m.max_phones,
        max_frames=m.max_frames,
    )
    # the sidecar's d-vector table and stats keep speaker identity and
    # normalization as in training (unknown speakers take hash placeholders)
    s2d = sidecar.get("speaker2dvector")
    ds = TTSDataset(
        root=Path(args.dataset), cfg=dcfg, compute_stats=False,
        stats=sidecar.get("stats"),
        speaker2dvector={k: np.asarray(v) for k, v in s2d.items()} if s2d else None,
        device=_device(args, args.tts_device),
    )
    out_dir = Path(args.output_path)
    budget_s = args.hours * 3600
    total_s = 0.0
    written = {}
    for idx in range(len(ds)):
        item = ds.__getitem__(idx, augment=False)
        batch = ds.collate([item])
        wav = gen.generate_samples(
            {k: v for k, v in batch.items() if isinstance(v, np.ndarray)})[0]
        speaker_dir = out_dir / str(item["speaker_key"])
        speaker_dir.mkdir(parents=True, exist_ok=True)
        gen.save_audio(speaker_dir / f"{item['id']}.wav", wav)
        # the ground truth beside the synthesis (reference generate.py:228-231)
        try:
            shutil.copyfile(ds.entries[idx].audio_path,
                            speaker_dir / f"{item['id']}_original.wav")
        except OSError:
            pass
        (speaker_dir / f"{item['id']}.lab").write_text(item.get("text", ""))
        with open(speaker_dir / f"{item['id']}.meta", "wb") as fh:
            pickle.dump({"phones": item["phones"], "durations": item["duration"]}, fh)
        written[f"{item['speaker_key']}/{item['id']}"] = wav
        total_s += len(wav) / gen.output_sampling_rate
        if total_s >= budget_s:
            break
    print(f"re-synthesized {total_s / 3600:.2f} hours into {out_dir}")
    return written


def main(argv=None):
    """Sentence mode writes ``<output_path>/sentence.wav`` and returns the
    float waveform it wrote (before the int16 write); ``--dataset`` mode
    returns ``resynthesize_dataset``'s waveforms."""
    from lightningfastspeech2_tpu_torch.core.device import f32_convolutions

    args = build_parser().parse_args(argv)
    if not (args.sentence or args.dataset):
        raise SystemExit("provide --sentence or --dataset")
    f32_convolutions(32)   # the acoustic model serves in f32
    gen, cfg, sidecar = load_generator(args)
    chain = postprocess_chain(args)
    if chain is not None:
        gen.set_postprocess(chain)
    out_dir = Path(args.output_path)
    out_dir.mkdir(parents=True, exist_ok=True)
    if not args.sentence:
        return resynthesize_dataset(gen, cfg, sidecar, args)
    wav = synthesize_sentence(gen, cfg, args)
    out = out_dir / "sentence.wav"
    gen.save_audio(out, wav)
    print(f"wrote {out} ({len(wav) / gen.output_sampling_rate:.2f}s)")
    return wav


if __name__ == "__main__":
    main()
