"""The port's own copy of ``lightningfastspeech2_tpu/core/config.py``: the
same dataclasses and presets, so a config serializes to identical JSON in
both packages. The port imports nothing of the JAX package.

Configuration tree for the TPU-native FastSpeech2 framework.

The reference exposes ~100 argparse flags spread over
``FastSpeech2.__init__`` (reference ``litfass/fastspeech2/fastspeech2.py:46-130``),
``TTSDataset`` and the FastDiff group. Here the same surface is a single
typed, frozen dataclass tree that serializes to/from plain dicts (JSON), is
hashable (usable as a jit static argument), and is stored alongside
checkpoints.

Defaults reproduce the reference defaults exactly where they exist
(``fastspeech2.py:50-130``, ``scripts/train.sh``).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field, fields, is_dataclass
from typing import Any, Mapping, Optional, Tuple


def _freeze(value: Any) -> Any:
    if isinstance(value, list):
        return tuple(_freeze(v) for v in value)
    if isinstance(value, dict):
        return tuple(sorted((k, _freeze(v)) for k, v in value.items()))
    return value


@dataclass(frozen=True)
class AudioConfig:
    """Audio front-end parameters (reference ``fastspeech2.py:85-88``,
    ``datasets.py:54-55,184-199``)."""

    sampling_rate: int = 22050
    n_fft: int = 1024
    win_length: int = 1024
    hop_length: int = 256
    n_mels: int = 80
    f_min: float = 0.0
    f_max: float = 8000.0
    # log10 dynamic-range compression with clip 1e-6 (audio_utils.py:8-12)
    log10: bool = True
    clip_val: float = 1e-6


@dataclass(frozen=True)
class StackConfig:
    """One transformer (FFT-block) stack — encoder or decoder
    (reference ``fastspeech2.py:91-108``)."""

    hidden: int = 256
    heads: int = 2
    layers: int = 4
    dropout: float = 0.1
    # per-layer conv kernel sizes; encoder default [5,25,13,9],
    # decoder default [17,21,9,13] (fastspeech2.py:95,104)
    kernel_sizes: Tuple[int, ...] = (5, 25, 13, 9)
    conformer: bool = True
    depthwise: bool = True
    conv_filter_size: int = 1024
    # only used when conformer=False (vanilla FFN fallback,
    # fastspeech2.py:288-295)
    dim_feedforward: Optional[int] = None

    def __post_init__(self):
        object.__setattr__(self, "kernel_sizes", tuple(self.kernel_sizes))
        if self.conformer and len(self.kernel_sizes) != self.layers:
            raise ValueError(
                f"kernel_sizes {self.kernel_sizes} must have one entry per "
                f"layer ({self.layers})"
            )


@dataclass(frozen=True)
class VarianceConfig:
    """Variance adaptor surface (reference ``fastspeech2.py:59-76``,
    ``model.py:167-341``)."""

    variances: Tuple[str, ...] = ("pitch", "energy", "snr")
    levels: Tuple[str, ...] = ("frame", "frame", "frame")  # "phone"|"frame"
    transforms: Tuple[str, ...] = ("cwt", "none", "none")  # "cwt"|"log"|"none"
    losses: Tuple[str, ...] = ("mse", "mse", "mse")
    nlayers: Tuple[int, ...] = (5, 5, 5)
    kernel_sizes: Tuple[int, ...] = (3, 3, 3)
    dropouts: Tuple[float, ...] = (0.5, 0.5, 0.5)
    loss_weights: Tuple[float, ...] = (5e-2, 5e-2, 5e-2)
    filter_size: int = 256
    nbins: int = 256
    depthwise: bool = True

    def __post_init__(self):
        for name in ("variances", "levels", "transforms", "losses", "nlayers",
                     "kernel_sizes", "dropouts", "loss_weights"):
            object.__setattr__(self, name, tuple(getattr(self, name)))
        n = len(self.variances)
        for name in ("levels", "transforms", "losses", "nlayers",
                     "kernel_sizes", "dropouts", "loss_weights"):
            if len(getattr(self, name)) != n:
                raise ValueError(
                    f"{name} must have {n} entries (one per variance), got "
                    f"{getattr(self, name)}"
                )

    def index(self, var: str) -> int:
        return self.variances.index(var)


@dataclass(frozen=True)
class DurationConfig:
    """Duration predictor (reference ``fastspeech2.py:70-76``)."""

    nlayers: int = 2
    stochastic: bool = False  # flow-based SDP when True (sdp.py)
    kernel_size: int = 3
    dropout: float = 0.5
    filter_size: int = 256
    depthwise: bool = True
    loss: str = "mse"
    loss_weight: float = 5e-1


@dataclass(frozen=True)
class ModelConfig:
    """Full acoustic-model configuration."""

    encoder: StackConfig = field(default_factory=StackConfig)
    decoder: StackConfig = field(
        default_factory=lambda: StackConfig(kernel_sizes=(17, 21, 9, 13))
    )
    variance: VarianceConfig = field(default_factory=VarianceConfig)
    duration: DurationConfig = field(default_factory=DurationConfig)
    audio: AudioConfig = field(default_factory=AudioConfig)

    speaker_type: str = "dvector"  # "none" | "id" | "dvector"
    n_speakers: int = 2500
    dvector_dim: int = 256
    priors: Tuple[str, ...] = ()  # subset of ("pitch","energy","snr","duration")
    prior_nbins: int = 256
    speaker_embedding_every_layer: bool = False
    prior_embedding_every_layer: bool = False

    # FastDiff options (reference scripts/train.sh:50-53)
    fastdiff_variances: bool = False   # diffusion variance adaptor
    fastdiff_speakers: bool = False    # diffusion d-vector generator
    fastdiff_vocoder: bool = False     # joint vocoder fine-tuning
    fastdiff_schedule: Tuple[float, ...] = (0.0, 1.0)  # P(use predicted mel)
    fastdiff_schedule_end: int = 20    # epochs over which the schedule runs
    fastdiff_inference_steps: int = 4
    # FastDiff vocoder architecture (reference FastDiff.py:217-255 argparse
    # defaults; upsample ratios must multiply to audio.hop_length)
    fastdiff_inner_channels: int = 32
    fastdiff_upsample_ratios: Tuple[int, ...] = (8, 8, 4)
    fastdiff_lvc_layers: int = 4
    fastdiff_kpnet_hidden: int = 64
    fastdiff_diffusion_T: int = 1000

    vocab_size: int = 256  # phone vocabulary incl. [PAD]=0
    # static-shape contract: max phones per utterance and max mel frames
    # (reference bounds utterances to 32 s -> <=2757 frames,
    # datasets.py:83-85, fastspeech2.py:318-320; we round up to a lane
    # multiple)
    max_phones: int = 512
    max_frames: int = 2816
    # teacher-forced duration/variance ratio (model.py:272)
    tf_ratio: float = 1.0

    def __post_init__(self):
        object.__setattr__(self, "priors", tuple(self.priors))
        object.__setattr__(self, "fastdiff_schedule",
                           tuple(self.fastdiff_schedule))
        object.__setattr__(self, "fastdiff_upsample_ratios",
                           tuple(self.fastdiff_upsample_ratios))

    @property
    def hidden(self) -> int:
        return self.encoder.hidden


@dataclass(frozen=True)
class TrainConfig:
    """Optimization setup (reference ``fastspeech2.py:1166-1182``,
    ``scripts/train.sh:3-12``)."""

    lr: float = 1e-4
    warmup_steps: int = 4000
    betas: Tuple[float, float] = (0.9, 0.98)
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    batch_size: int = 6
    grad_accum: int = 1
    max_steps: int = 100_000
    bf16: bool = True  # bfloat16 activations, f32 params/optimizer
    # store the Adam first moment (mu) in bfloat16: cuts optimizer-state
    # HBM (and its per-step read/write traffic) by a third at a small
    # precision cost; nu/params/updates stay f32
    bf16_moments: bool = False
    # compute mel/pitch/energy/SNR on-device inside the train step from raw
    # waveforms (requires DataConfig.raw_mode batches)
    on_device_features: bool = False
    seed: int = 42
    mel_loss: str = "l1"
    mel_loss_weight: float = 1.0
    soft_dtw_gamma: float = 0.1
    soft_dtw_chunk_size: int = 256
    log_every: int = 50
    eval_every: int = 1000
    checkpoint_every: int = 1000
    variance_early_stopping: str = "none"  # "mae" | "js" | "none"
    variance_early_stopping_patience: int = 4
    # host input pipeline (reference DataLoader num_workers=cpu_count,
    # fastspeech2.py:42,114): 0 = synchronous in-loop item computation,
    # N > 0 = N worker processes with `prefetch` batches in flight
    num_workers: int = 0
    prefetch: int = 4
    # ZeRO-1: shard optimizer moments over the data axis (train/step.py)
    zero1: bool = False
    # stochastic weight averaging (reference train.py:282-283)
    swa: bool = False
    swa_start_pct: float = 0.75  # Lightning SWA default: last 25% of steps
    # hardware PRNG for dropout/noise draws (core/compile_cache.py
    # enable_fast_prng): threefry costs ~12 ms/step at the flagship shapes
    fast_prng: bool = True


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh layout (see parallel/mesh.py)."""

    data: int = -1  # -1: use all remaining devices
    model: int = 1

    def __post_init__(self):
        if self.model < 1:
            raise ValueError("model axis must be >= 1")


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)


# ---------------------------------------------------------------------------
# (de)serialization
# ---------------------------------------------------------------------------

def to_dict(cfg: Any) -> Any:
    """Recursively convert a config dataclass to JSON-safe plain data."""
    if is_dataclass(cfg):
        return {f.name: to_dict(getattr(cfg, f.name)) for f in fields(cfg)}
    if isinstance(cfg, (tuple, list)):
        return [to_dict(v) for v in cfg]
    return cfg


def from_dict(cls, data: Mapping[str, Any]):
    """Inverse of :func:`to_dict` for a given dataclass type."""
    kwargs = {}
    for f in fields(cls):
        if f.name not in data:
            continue
        value = data[f.name]
        ftype = f.type if not isinstance(f.type, str) else None
        default = f.default_factory() if f.default_factory is not dataclasses.MISSING else f.default  # type: ignore[misc]
        if is_dataclass(default):
            kwargs[f.name] = from_dict(type(default), value)
        elif ftype is not None and is_dataclass(ftype):
            kwargs[f.name] = from_dict(ftype, value)
        else:
            kwargs[f.name] = value
    return cls(**kwargs)


def save_json(cfg: Config, path: str) -> None:
    with open(path, "w") as fh:
        json.dump(to_dict(cfg), fh, indent=2)


def load_json(path: str) -> Config:
    with open(path) as fh:
        return from_dict(Config, json.load(fh))


def replace(cfg, **kwargs):
    """`dataclasses.replace` that accepts dotted paths, e.g.
    ``replace(cfg, **{"model.encoder.hidden": 384})``."""
    flat = {k: v for k, v in kwargs.items() if "." not in k}
    nested: dict = {}
    for k, v in kwargs.items():
        if "." in k:
            head, rest = k.split(".", 1)
            nested.setdefault(head, {})[rest] = v
    for head, sub in nested.items():
        flat[head] = replace(getattr(cfg, head), **sub)
    return dataclasses.replace(cfg, **flat)


# Canonical model presets
def fastspeech2_27m() -> Config:
    """Single-speaker FastSpeech2 ~27M, vanilla convs, deterministic duration."""
    enc = StackConfig(depthwise=False)
    dec = StackConfig(depthwise=False, kernel_sizes=(17, 21, 9, 13))
    var = VarianceConfig(
        variances=("pitch", "energy"),
        levels=("phone", "phone"),
        transforms=("none", "none"),
        losses=("mse", "mse"),
        nlayers=(2, 2),
        kernel_sizes=(3, 3),
        dropouts=(0.5, 0.5),
        loss_weights=(1e-1, 1e-1),
        depthwise=False,
    )
    dur = DurationConfig(depthwise=False)
    model = ModelConfig(
        encoder=enc, decoder=dec, variance=var, duration=dur,
        speaker_type="none", n_speakers=1,
    )
    return Config(model=model)


def lightspeech_flagship() -> Config:
    """Multi-speaker LightSpeech flagship: depthwise-separable convs +
    d-vectors at reference-HEAD default dims (reference README.md:10,
    scripts/train.sh).

    measured_params = 7.9M. The reference README claims "76M" for this
    config but neither 27M nor 76M is reachable from any in-tree reference
    config (BASELINE.md "Param-count correction"); the measured count is
    authoritative and is emitted as ``n_params`` in bench output. For a
    genuinely 76M-class model use :func:`lightspeech_true76m`.
    """
    model = ModelConfig(speaker_type="dvector", n_speakers=2500)
    return Config(model=model)


def lightspeech_true76m() -> Config:
    """A genuinely 76M-parameter LightSpeech-style config: hidden 640, 8
    encoder + 7 decoder depthwise-conformer layers, conv filter 2560 (= 4x
    hidden: the grouped conv fold requires filter % hidden == 0), 5 heads
    (head_dim 128), d-vectors over 2500 speakers. The reference README's
    76M-class scale target (reference README.md:10)."""
    base = ModelConfig(speaker_type="dvector", n_speakers=2500)
    enc = replace(base.encoder, hidden=640, layers=8, heads=5,
                  conv_filter_size=2560,
                  kernel_sizes=(5, 25, 13, 9, 17, 21, 9, 13))
    dec = replace(base.decoder, hidden=640, layers=7, heads=5,
                  conv_filter_size=2560,
                  kernel_sizes=(17, 21, 9, 13, 5, 25, 13))
    model = dataclasses.replace(base, encoder=enc, decoder=dec)
    return Config(model=model)


def canonical_joint() -> Config:
    """The reference's canonical experiment composition (reference
    scripts/train.sh:44-55): the flagship acoustic stack (256 hidden, 4
    encoder + 6 decoder depthwise layers, d-vectors) with FastDiff vocoder
    fine-tuning, the diffusion variance adaptor over four frame-level
    variances (pitch, energy, snr, srmr) and the diffusion speaker
    generator."""
    base = lightspeech_flagship().model
    var = replace(
        base.variance,
        variances=("pitch", "energy", "snr", "srmr"),
        levels=("frame",) * 4,
        transforms=("none",) * 4,
        losses=("mse",) * 4,
        nlayers=(5, 5, 5, 5),
        kernel_sizes=(5, 5, 5, 5),
        dropouts=(0.1,) * 4,
        loss_weights=(1.0,) * 4,
    )
    dec = replace(base.decoder, layers=6, kernel_sizes=(9,) * 6)
    dur = replace(base.duration, nlayers=5)
    model = dataclasses.replace(
        base, variance=var, decoder=dec, duration=dur,
        fastdiff_vocoder=True, fastdiff_variances=True,
        fastdiff_speakers=True,
    )
    return Config(model=model)
