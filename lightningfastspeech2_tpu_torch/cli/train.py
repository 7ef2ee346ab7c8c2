"""Training CLI.

Counterpart of ``lightningfastspeech2_tpu/cli/train.py``: the same flags,
defaults and config (``args_to_config``), flag-compatible with the
reference where sensible (reference ``litfass/train.py:29-93``,
``scripts/train.sh``), plus ``--device`` (``cuda`` unless ``cpu``, as the
generate CLI):

    python -m lightningfastspeech2_tpu_torch.cli.train \\
        --train_target_path corpus/train --valid_target_path corpus/valid \\
        --checkpoint_dir ckpts --max_steps 10000

``main`` runs in the JAX CLI's order: dataset -> d-vectors (and
``dvector_gmms.pkl``) -> sort -> validation set -> fit (logged steps, evals,
asynchronous checkpoints, an optional warm start) -> final checkpoint ->
SWA checkpoint under ``swa/`` -> final eval -> priors in the sidecar and
``prior_gmms.pkl``. The checkpoint directory is what the port's generate
CLI serves.

Under ``python -m torch.distributed.run --nproc_per_node N -m
lightningfastspeech2_tpu_torch.cli.train ...`` N ranks train one model on
the global batch ``--batch_size`` (parallel/mesh.py): the mesh's data axis
(every rank ``--mesh_model`` leaves, halved until it divides the batch, as
the JAX CLI halves it) splits the corpus and each batch, ``--mesh_model``
replicates, ``--zero1`` shards the optimizer's moments over the data axis.
Rank 0 writes the feature and d-vector caches first (the others then read
them), the GMM pickles, the checkpoints and the logs. In one process the
mesh flags and ``--zero1`` change nothing, as in the JAX CLI on one device.
``--fastdiff_vocoder`` trains the joint acoustic + FastDiff module (the
dataset then loads each wav), ``--fastdiff_variances`` /
``--fastdiff_speakers`` the diffusion adaptor and speaker generator,
``--duration_stochastic`` the flow-based duration predictor, and an
``srmr`` variance comes from ``audio/srmr.py``. ``--on_device_features``
ships raw wavs (int16 under ``--wav_transfer_dtype int16``) and computes
the features in the train step (``train/on_device_features.py``); raw-mode
items carry no priors, so with ``--priors`` it raises, where the JAX CLI
fails on the missing ``priors_*`` at its first batch.
"""

from __future__ import annotations

import argparse
import pickle
from pathlib import Path


def str2bool(v: str) -> bool:  # reference third_party/argutils semantics
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("boolean value expected")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="FastSpeech2 training (PyTorch / CUDA)")
    # data
    p.add_argument("--train_target_path", type=str, required=True,
                   help="aligned corpus root (wav + TextGrid pairs)")
    p.add_argument("--valid_target_path", type=str, default=None)
    p.add_argument("--train_min_samples_per_speaker", type=int, default=0)
    p.add_argument("--min_length", type=float, default=0.5)
    p.add_argument("--max_length", type=float, default=32.0)
    p.add_argument("--augment_duration", type=float, default=0.1)
    p.add_argument("--sort_data_by_length", type=str2bool, default=False)
    p.add_argument("--stat_entries", type=int, default=10000)
    # variances
    p.add_argument("--variances", nargs="+", default=["pitch", "energy", "snr"])
    p.add_argument("--variance_levels", nargs="+",
                   default=["frame", "frame", "frame"])
    p.add_argument("--variance_transforms", nargs="+",
                   default=["none", "none", "none"])
    p.add_argument("--variance_losses", nargs="+", default=["mse", "mse", "mse"])
    p.add_argument("--variance_nlayers", nargs="+", type=int, default=[5, 5, 5])
    p.add_argument("--variance_kernel_size", nargs="+", type=int, default=[3, 3, 3])
    p.add_argument("--variance_dropout", nargs="+", type=float,
                   default=[0.5, 0.5, 0.5])
    p.add_argument("--variance_loss_weights", nargs="+", type=float,
                   default=[5e-2, 5e-2, 5e-2])
    p.add_argument("--variance_filter_size", type=int, default=256)
    p.add_argument("--variance_nbins", type=int, default=256)
    p.add_argument("--variance_depthwise_conv", type=str2bool, default=True)
    p.add_argument("--variance_early_stopping", type=str, default="none",
                   choices=["none", "mae", "js"])
    p.add_argument("--variance_early_stopping_patience", type=int, default=4)
    # duration
    p.add_argument("--duration_nlayers", type=int, default=2)
    p.add_argument("--duration_stochastic", type=str2bool, default=False)
    p.add_argument("--duration_kernel_size", type=int, default=3)
    p.add_argument("--duration_dropout", type=float, default=0.5)
    p.add_argument("--duration_filter_size", type=int, default=256)
    p.add_argument("--duration_depthwise_conv", type=str2bool, default=True)
    p.add_argument("--duration_loss_weight", type=float, default=5e-1)
    # encoder/decoder
    for side, kernels in (("encoder", [5, 25, 13, 9]), ("decoder", [17, 21, 9, 13])):
        p.add_argument(f"--{side}_hidden", type=int, default=256)
        p.add_argument(f"--{side}_head", type=int, default=2)
        p.add_argument(f"--{side}_layers", type=int, default=4)
        p.add_argument(f"--{side}_dropout", type=float, default=0.1)
        p.add_argument(f"--{side}_kernel_sizes", nargs="+", type=int,
                       default=kernels)
        p.add_argument(f"--{side}_conformer", type=str2bool, default=True)
        p.add_argument(f"--{side}_depthwise_conv", type=str2bool, default=True)
        p.add_argument(f"--{side}_conv_filter_size", type=int, default=1024)
    # FastDiff (reference litfass/train.py:73-91, scripts/train.sh:44-47)
    p.add_argument("--fastdiff_vocoder", type=str2bool, default=False,
                   help="joint acoustic+FastDiff vocoder training")
    p.add_argument("--fastdiff_variances", type=str2bool, default=False,
                   help="diffusion variance adaptor")
    p.add_argument("--fastdiff_speakers", type=str2bool, default=False,
                   help="diffusion d-vector speaker generator")
    p.add_argument("--fastdiff_schedule", nargs="+", type=float,
                   default=[0.0, 1.0],
                   help="per-epoch P(condition vocoder on predicted mel)")
    p.add_argument("--fastdiff_schedule_end", type=int, default=20)
    p.add_argument("--fastdiff_n", type=int, default=4,
                   help="reverse-diffusion steps at inference")
    p.add_argument("--fastdiff_inner_channels", type=int, default=32)
    p.add_argument("--fastdiff_upsample_ratios", nargs="+", type=int,
                   default=[8, 8, 4])
    p.add_argument("--fastdiff_lvc_layers", type=int, default=4)
    p.add_argument("--fastdiff_kpnet_hidden", type=int, default=64)
    p.add_argument("--fastdiff_diffusion_T", type=int, default=1000)
    # speakers & priors
    p.add_argument("--speaker_type", type=str, default="dvector",
                   choices=["none", "id", "dvector", "dvector_utterance"])
    p.add_argument("--compute_dvectors", type=str2bool, default=True,
                   help="embed every utterance with the d-vector LSTM at "
                        "dataset init (reference datasets.py:652-690); "
                        "False falls back to deterministic placeholders")
    p.add_argument("--dvector_gmm", type=str2bool, default=False,
                   help="fit per-speaker GMMs over utterance d-vectors "
                        "for novel-voice sampling (reference "
                        "fastspeech2.py:121,492-499)")
    p.add_argument("--dvector_checkpoint", type=str, default=None,
                   help="torch d-vector state-dict (yistLin topology) for "
                        "the embedding pipeline")
    p.add_argument("--priors", nargs="*", default=[])
    p.add_argument("--priors_gmm", type=str2bool, default=False)
    p.add_argument("--priors_gmm_max_components", type=int, default=5)
    p.add_argument("--speaker_embedding_every_layer", type=str2bool, default=False)
    p.add_argument("--prior_embedding_every_layer", type=str2bool, default=False)
    # optimization (reference defaults: fastspeech2.py:50-56, train.sh)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--warmup_steps", type=int, default=4000)
    p.add_argument("--batch_size", type=int, default=6)
    p.add_argument("--accumulate_grad_batches", type=int, default=1)
    p.add_argument("--gradient_clip_val", type=float, default=1.0)
    p.add_argument("--max_steps", type=int, default=100000)
    p.add_argument("--mel_loss", type=str, default="l1")
    p.add_argument("--soft_dtw_gamma", type=float, default=0.1)
    p.add_argument("--soft_dtw_chunk_size", type=int, default=256)
    p.add_argument("--precision", type=str, default="bf16",
                   choices=["bf16", "32"])
    p.add_argument("--bf16_moments", type=str2bool, default=False,
                   help="Adam first moment in bf16 (cuts optimizer-state "
                        "memory a third)")
    p.add_argument("--on_device_features", type=str2bool, default=False,
                   help="extract mel/pitch/energy/SNR on the device inside the "
                        "train step (raw-wav host pipeline)")
    p.add_argument("--seed", type=int, default=42)
    # host input pipeline (reference DataLoader num_workers=cpu_count,
    # fastspeech2.py:42,114); default: leave 2 CPUs for the main process
    import os as _os

    p.add_argument("--num_workers", type=int,
                   default=max((_os.cpu_count() or 2) - 2, 2))
    p.add_argument("--prefetch", type=int, default=4)
    p.add_argument("--mel_transfer_dtype", type=str, default="auto",
                   choices=("auto", "float32", "bfloat16"),
                   help="collated-mel storage dtype; auto = bfloat16 when "
                        "--precision bf16 (halves the dominant batch "
                        "payload; see DataConfig.mel_dtype)")
    p.add_argument("--wav_transfer_dtype", type=str, default="int16",
                   choices=("float32", "int16"),
                   help="waveform transfer dtype when batches carry audio "
                        "(joint FastDiff / --on_device_features); int16 "
                        "quarters the payload, dequantized on device")
    p.add_argument("--swa", type=str2bool, default=False,
                   help="stochastic weight averaging over the last 25% of "
                        "steps (reference train.py:282-283)")
    # mesh
    p.add_argument("--mesh_data", type=int, default=-1)
    p.add_argument("--mesh_model", type=int, default=1)
    p.add_argument("--zero1", type=str2bool, default=False,
                   help="shard optimizer moments over the data mesh axis")
    # io
    p.add_argument("--checkpoint_dir", type=str, default="checkpoints")
    p.add_argument("--async_checkpoints", type=str2bool, default=True,
                   help="write checkpoints on a background thread: the train "
                        "loop only blocks for the device->host copy, not the "
                        "disk write")
    p.add_argument("--cache_path", type=str, default=None,
                   help="dataset scan/stats cache directory (reference "
                        "--cache_path analog)")
    p.add_argument("--from_checkpoint", type=str, default=None)
    p.add_argument("--log_dir", type=str, default="logs")
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--eval_every", type=int, default=1000)
    p.add_argument("--checkpoint_every", type=int, default=1000)
    p.add_argument("--early_stopping", type=str2bool, default=False)
    p.add_argument("--early_stopping_patience", type=int, default=10)
    p.add_argument("--wandb_mode", type=str, default="offline")
    p.add_argument("--wandb_project", type=str, default=None)
    p.add_argument("--log_eval_media", type=str2bool, default=True,
                   help="write pred/true spectrogram pngs under "
                        "log_dir/eval_examples every eval (reference logs "
                        "these to wandb, fastspeech2.py:809-957)")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="cuda (the kernels) or cpu (their plain versions)")
    return p


def args_to_config(args):
    from lightningfastspeech2_tpu_torch.core import config as C

    n = len(args.variances)

    def fit_list(lst, fill=None):
        lst = list(lst)
        while len(lst) < n:
            lst.append(fill if fill is not None else lst[-1])
        return tuple(lst[:n])

    variance = C.VarianceConfig(
        variances=tuple(args.variances),
        levels=fit_list(args.variance_levels),
        transforms=fit_list(args.variance_transforms),
        losses=fit_list(args.variance_losses),
        nlayers=fit_list(args.variance_nlayers),
        kernel_sizes=fit_list(args.variance_kernel_size),
        dropouts=fit_list(args.variance_dropout),
        loss_weights=fit_list(args.variance_loss_weights),
        filter_size=args.variance_filter_size,
        nbins=args.variance_nbins,
        depthwise=args.variance_depthwise_conv,
    )
    duration = C.DurationConfig(
        nlayers=args.duration_nlayers,
        stochastic=args.duration_stochastic,
        kernel_size=args.duration_kernel_size,
        dropout=args.duration_dropout,
        filter_size=args.duration_filter_size,
        depthwise=args.duration_depthwise_conv,
        loss_weight=args.duration_loss_weight,
    )

    def stack(side):
        g = lambda k: getattr(args, f"{side}_{k}")
        return C.StackConfig(
            hidden=g("hidden"), heads=g("head"), layers=g("layers"),
            dropout=g("dropout"),
            kernel_sizes=tuple(g("kernel_sizes"))[: g("layers")],
            conformer=g("conformer"), depthwise=g("depthwise_conv"),
            conv_filter_size=g("conv_filter_size"),
        )

    model = C.ModelConfig(
        encoder=stack("encoder"), decoder=stack("decoder"),
        variance=variance, duration=duration,
        speaker_type=args.speaker_type,
        priors=tuple(args.priors),
        speaker_embedding_every_layer=args.speaker_embedding_every_layer,
        prior_embedding_every_layer=args.prior_embedding_every_layer,
        fastdiff_vocoder=args.fastdiff_vocoder,
        fastdiff_variances=args.fastdiff_variances,
        fastdiff_speakers=args.fastdiff_speakers,
        fastdiff_schedule=tuple(args.fastdiff_schedule),
        fastdiff_schedule_end=args.fastdiff_schedule_end,
        fastdiff_inference_steps=args.fastdiff_n,
        fastdiff_inner_channels=args.fastdiff_inner_channels,
        fastdiff_upsample_ratios=tuple(args.fastdiff_upsample_ratios),
        fastdiff_lvc_layers=args.fastdiff_lvc_layers,
        fastdiff_kpnet_hidden=args.fastdiff_kpnet_hidden,
        fastdiff_diffusion_T=args.fastdiff_diffusion_T,
    )
    train = C.TrainConfig(
        lr=args.lr, warmup_steps=args.warmup_steps,
        batch_size=args.batch_size, grad_accum=args.accumulate_grad_batches,
        grad_clip=args.gradient_clip_val, max_steps=args.max_steps,
        bf16=args.precision == "bf16", bf16_moments=args.bf16_moments,
        seed=args.seed,
        on_device_features=args.on_device_features,
        mel_loss=args.mel_loss, soft_dtw_gamma=args.soft_dtw_gamma,
        soft_dtw_chunk_size=args.soft_dtw_chunk_size,
        log_every=args.log_every, eval_every=args.eval_every,
        checkpoint_every=args.checkpoint_every,
        variance_early_stopping=args.variance_early_stopping,
        variance_early_stopping_patience=args.variance_early_stopping_patience,
        num_workers=args.num_workers, prefetch=args.prefetch,
        zero1=args.zero1, swa=args.swa,
    )
    mesh = C.MeshConfig(data=args.mesh_data, model=args.mesh_model)
    return C.Config(model=model, train=train, mesh=mesh)


def check_flags(args) -> None:
    """Raise for flags that cannot train together: raw-mode items
    (``--on_device_features``) carry no ``priors_*``, which the model's
    prior embeddings read (the JAX CLI raises a KeyError at its first
    batch)."""
    if args.on_device_features and args.priors:
        raise ValueError("--priors needs the host features: raw-mode batches "
                         "(--on_device_features) carry no priors_*")


def data_config(args, cfg):
    """The dataset's config for the parsed arguments and ``args_to_config``'s
    config (the JAX CLI's)."""
    from lightningfastspeech2_tpu_torch.data.dataset import DataConfig

    return DataConfig(
        min_length=args.min_length, max_length=args.max_length,
        variances=tuple(args.variances),
        variance_levels=cfg.model.variance.levels,
        variance_transforms=cfg.model.variance.transforms,
        priors=tuple(args.priors),
        augment_duration=args.augment_duration,
        speaker_type=args.speaker_type,
        min_samples_per_speaker=args.train_min_samples_per_speaker,
        stat_entries=args.stat_entries,
        raw_mode=args.on_device_features,
        mel_dtype=("bfloat16" if args.precision in ("bf16", "16") else "float32")
        if args.mel_transfer_dtype == "auto" else args.mel_transfer_dtype,
        wav_dtype=args.wav_transfer_dtype,
        load_wav=args.fastdiff_vocoder,
        seed=args.seed,
        max_phones=cfg.model.max_phones,
        max_frames=cfg.model.max_frames,
        scan_workers=args.num_workers,
    )


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = args_to_config(args)
    check_flags(args)

    import torch.distributed as dist

    from lightningfastspeech2_tpu_torch.parallel import mesh as mesh_lib

    # before the device is resolved: each rank's card becomes its current one
    backend = mesh_lib.distributed_init(args.device)
    try:
        return _train(args, cfg)
    finally:
        if backend is not None:
            dist.destroy_process_group()


def make_train_mesh(cfg, batch_size: int):
    """The mesh of the ranks of the process group (None in one process):
    the JAX CLI's layout, its data axis halved until it divides the global
    batch. Every rank must find a place in it."""
    from lightningfastspeech2_tpu_torch.core.config import MeshConfig
    from lightningfastspeech2_tpu_torch.parallel import mesh as mesh_lib

    n = mesh_lib.world_size()
    if n == 1:
        return None
    mesh_lib.mesh_layout(cfg.mesh, n)
    data = mesh_lib.data_axis_for_batch(cfg.mesh, n, batch_size)
    if data * cfg.mesh.model != n:
        raise ValueError(f"the data axis halves to {data} to divide the global batch "
                         f"{batch_size}: a {data}x{cfg.mesh.model} mesh leaves ranks of the "
                         f"{n} out; pick a batch that {n // cfg.mesh.model} ranks divide")
    mesh = mesh_lib.make_mesh(MeshConfig(data=data, model=cfg.mesh.model))
    print(f"mesh: data={data} model={cfg.mesh.model}", flush=True)
    return mesh


def _train(args, cfg):
    import contextlib
    import copy

    import torch

    from lightningfastspeech2_tpu_torch.core.checkpoint import Checkpointer, warm_start
    from lightningfastspeech2_tpu_torch.core.device import f32_convolutions, resolve_device
    from lightningfastspeech2_tpu_torch.data.dataset import TTSDataset
    from lightningfastspeech2_tpu_torch.models.joint import flatten_joint, nest_joint
    from lightningfastspeech2_tpu_torch.parallel import mesh as mesh_lib
    from lightningfastspeech2_tpu_torch.train.loop import (
        StopTraining, build_model, encoder_snapshot, evaluate, fit)
    from lightningfastspeech2_tpu_torch.train.metrics_logger import MetricsLogger
    from lightningfastspeech2_tpu_torch.train.step import (
        TrainState, create_train_state, optimizer_state_dict)

    f32_convolutions(args.precision)
    device = resolve_device(args.device)
    main_rank = mesh_lib.is_main()
    mesh = make_train_mesh(cfg, args.batch_size)
    dcfg = data_config(args, cfg)
    print(f"scanning corpus {args.train_target_path} ...", flush=True)
    cache = Path(args.cache_path) if args.cache_path else None
    # every rank parses the corpus at once; with a cache, rank 0 computes
    # the statistics (filling the feature cache and the stats JSON) and the
    # others then read them
    dataset = TTSDataset(root=Path(args.train_target_path), cfg=dcfg, cache_dir=cache,
                         device=device, compute_stats=False)
    with mesh_lib.main_first("dataset_stats") if cache else contextlib.nullcontext():
        dataset.compute_stats(cache)
    print(f"{len(dataset)} utterances, {len(dataset.speakers)} speakers, "
          f"{len(dataset.vocab)} phones", flush=True)
    if args.compute_dvectors and "dvector" in args.speaker_type and len(dataset):
        # per-utterance d-vectors and speaker means (reference embeds at
        # dataset init, datasets.py:652-690) in place of hash placeholders
        from lightningfastspeech2_tpu_torch.data.dvector import DVectorPipeline

        state_dict = None
        if args.dvector_checkpoint:
            state_dict = torch.load(args.dvector_checkpoint, map_location="cpu",
                                    weights_only=True)
        pipeline = DVectorPipeline(state_dict, sampling_rate=cfg.model.audio.sampling_rate,
                                   device=device)
        # rank 0 writes the d-vector files beside the audio, the others read
        with mesh_lib.main_first("dvectors"):
            dataset.create_dvectors(pipeline)
        print(f"d-vectors: embedded {len(dataset)} utterances, "
              f"{len(dataset.speaker2dvector)} speaker vectors", flush=True)
        if args.dvector_gmm and main_rank:
            from lightningfastspeech2_tpu_torch.utils.log_gmm import fit_dvector_gmms

            dvector_gmms = fit_dvector_gmms(dataset.get_speaker_dvectors())
            Path(args.checkpoint_dir).mkdir(parents=True, exist_ok=True)
            with open(Path(args.checkpoint_dir) / "dvector_gmms.pkl", "wb") as fh:
                pickle.dump(dvector_gmms, fh)
            print(f"fitted d-vector GMMs for {len(dvector_gmms)} speakers")
    if len(dataset) == 0:
        raise SystemExit(f"no usable utterances under {args.train_target_path} (need "
                         "paired <utt>.wav + <utt>.TextGrid files)")
    if args.sort_data_by_length:
        dataset.sort_by_duration()
    train_set = dataset
    if mesh is not None:
        # each data rank keeps a strided slice of the scanned (seed-shuffled)
        # corpus; ``dataset`` stays whole for the priors
        train_set = copy.copy(dataset).shard_across_hosts(mesh)
        print(f"rank {mesh.rank}/{mesh_lib.world_size()}: {len(train_set)} local utterances",
              flush=True)
    valid = None
    if args.valid_target_path:
        valid = dataset.create_validation_dataset(Path(args.valid_target_path))
        if mesh is not None:
            valid.shard_across_hosts(mesh)

    logger = MetricsLogger(args.log_dir, use_wandb=args.wandb_mode == "online",
                           wandb_project=args.wandb_project)
    ckpt = Checkpointer(args.checkpoint_dir, use_async=args.async_checkpoints)
    sidecar = {"stats": dataset.stats, "phone2id": dataset.vocab.to_dict(),
               "speaker2id": dataset.speaker2id}
    if dataset.speaker2dvector:
        sidecar["speaker2dvector"] = dataset.speaker2dvector

    def save(step: int, state: TrainState, directory=ckpt, side=sidecar, params=None):
        # a joint model's weights as {"acoustic", "fastdiff"}, as the JAX CLI
        # writes them and the generate CLI serves them; every rank calls it
        # (a ZeRO-1 optimizer gathers its state), rank 0 writes
        params = params if params is not None else state.model.state_dict()
        return directory.save(step, nest_joint(params), cfg, side,
                              opt_state=optimizer_state_dict(state.optimizer))

    resume_state = None
    if args.from_checkpoint:
        # warm start (reference train.py:240-260, load_from_checkpoint with
        # strict=False): every tensor of matching name and shape restored, a
        # fresh optimizer whose schedule starts over, as in the JAX CLI; every
        # rank restores
        restored, _, _ = Checkpointer(args.from_checkpoint).restore()
        model0 = build_model(cfg, dataset, device=device)
        merged, used, dropped = warm_start(model0.state_dict(),
                                           flatten_joint(restored["params"]))
        model0.load_state_dict(merged)
        print(f"warm start: {used} tensors restored, {dropped} kept fresh")
        resume_state = create_train_state(model0, cfg, mesh)

    eval_fn = None
    if valid is not None and len(valid):
        from lightningfastspeech2_tpu_torch.train.metrics import VarianceEarlyStopping

        early_stopping = VarianceEarlyStopping(
            cfg.model.variance.variances, mode=cfg.train.variance_early_stopping,
            patience=cfg.train.variance_early_stopping_patience)
        best = {"loss": float("inf"), "stale": 0}

        def eval_fn(step_i, state):
            # the whole validation set's metrics on every rank, so that every
            # rank takes the same early-stopping decisions
            metrics = evaluate(cfg, valid, state.model,
                               media_dir=(Path(args.log_dir) / "eval_examples"
                                          if args.log_eval_media else None),
                               step=step_i + 1, mesh=mesh)
            logger.log(step_i, metrics)
            # best checkpoint on the eval mel loss (ModelCheckpoint analog,
            # reference train.py:265-273)
            mel_loss = metrics.get("eval/mel_loss", float("nan"))
            if mel_loss == mel_loss and mel_loss < best["loss"]:
                best["loss"], best["stale"] = mel_loss, 0
                path = save(step_i + 1, state)
                if main_rank:
                    (ckpt.dir / "best").write_text(path.name)
            else:
                best["stale"] += 1
                if args.early_stopping and best["stale"] >= args.early_stopping_patience:
                    print("early stopping: eval/mel_loss stalled")
                    raise StopTraining
            snapshots = {var: snap for var in cfg.model.variance.variances
                         if (snap := encoder_snapshot(state.model, var))}
            frozen = early_stopping.update(metrics, snapshots)
            restores = early_stopping.pop_restores()
            if restores:
                print(f"variance early stopping: freezing {sorted(restores)} "
                      "at their best weights")
            return frozen, restores

    # loss terms get the reference's train/{k}_loss names; the rate and
    # optimizer diagnostics keep their own
    non_loss = ("grad_norm", "steps_per_s", "lr")

    def train_log_fn(s, m):
        logger.log(s, {(f"train/{k}" if k in non_loss else f"train/{k}_loss"): v
                       for k, v in m.items()})

    try:
        result = fit(cfg, train_set, max_steps=args.max_steps, log_fn=train_log_fn,
                     checkpoint_fn=lambda step_i, state: save(step_i + 1, state),
                     eval_fn=eval_fn, state=resume_state, device=device, mesh=mesh)
        save(args.max_steps, result.state)
        if result.swa_params is not None:
            # the averaged weights as a checkpoint of their own
            save(args.max_steps, result.state,
                 directory=Checkpointer(Path(args.checkpoint_dir) / "swa"),
                 params={**result.state.model.state_dict(), **result.swa_params})
            print("saved SWA-averaged weights to checkpoint_dir/swa")
        if valid is not None and len(valid):
            logger.log(args.max_steps, evaluate(cfg, valid, result.state.model, mesh=mesh))
        if args.priors:
            # per-speaker priors always persist when priors are modelled: the
            # default "sample" strategy at synthesis needs them (reference
            # fastspeech2.py:622-634); rank 0 computes them over the whole
            # training set
            priors = dataset.create_priors() if main_rank else {}
            save(args.max_steps, result.state, side={**sidecar, "speaker2priors": priors})
            if main_rank:
                print(f"persisted priors for {len(priors)} speakers")
            if args.priors_gmm and main_rank:
                from lightningfastspeech2_tpu_torch.utils.log_gmm import fit_speaker_gmms

                gmms = fit_speaker_gmms(priors, tuple(args.priors),
                                        max_components=args.priors_gmm_max_components)
                with open(Path(args.checkpoint_dir) / "prior_gmms.pkl", "wb") as fh:
                    pickle.dump(gmms, fh)
                print(f"fitted prior GMMs for {len(gmms)} speakers")
    finally:
        ckpt.wait_until_finished()   # publish the write in flight
        logger.close()
    return result


if __name__ == "__main__":
    main()
