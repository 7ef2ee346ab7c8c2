"""Shared pieces of the port's parity tests (tests/test_torch_*.py): tiny
configs, seeded numpy weights in the JAX package's layouts, and the
``cuda_card`` fixture for kernel tests on the card."""

import contextlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch


@contextlib.contextmanager
def torch_threads(n: int):
    """torch's intra-op threads set to ``n`` inside the block. The tier-1
    run puts several test workers on one machine, each with a thread a
    core by default; a file whose time goes to many small torch ops runs
    several times faster at one thread there."""
    old = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(old)


@pytest.fixture
def cuda_card():
    """The CUDA device for kernel-vs-plain tests; skips without a Hopper
    card. Decided here, at run time, never at import or collection."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernel test)")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a Hopper card (sm_90a kernels)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def tf32_round(x):
    """f32 ``x`` rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32``: integer ops on the f32 bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_matmul(a, b, split):
    """``a @ b`` in f32 with TF32 operands: one product tf32(a) tf32(b), or
    (``split``) the split product a_hi b_lo + a_lo b_hi + a_hi b_hi with hi =
    tf32(x), lo = tf32(x - hi), as csrc/flash_attention.cu forms it. A
    product of two TF32 values is exact in f32; the sums round in f32."""
    ah, bh = tf32_round(a), tf32_round(b)
    if not split:
        return ah @ bh
    al, bl = tf32_round(a - ah), tf32_round(b - bh)
    return ah @ bl + al @ bh + ah @ bh


def tiny_config(C, **model_kwargs):
    """Flagship structure at test size: depthwise conformer stacks, frame-level
    pitch (CWT) / energy / SNR, d-vector speakers; hidden 32, 2+2 layers,
    filter 64. ``C`` is either package's ``core.config`` module."""
    enc = C.StackConfig(hidden=32, heads=2, layers=2, kernel_sizes=(3, 5),
                        conv_filter_size=64)
    dec = C.StackConfig(hidden=32, heads=2, layers=2, kernel_sizes=(5, 4),
                        conv_filter_size=64)
    var = C.VarianceConfig(filter_size=32, nbins=16, nlayers=(2, 2, 2))
    dur = C.DurationConfig(nlayers=2, filter_size=32)
    kwargs = dict(encoder=enc, decoder=dec, variance=var, duration=dur,
                  vocab_size=50, max_phones=32, max_frames=256,
                  speaker_type="dvector", n_speakers=4, dvector_dim=16)
    kwargs.update(model_kwargs)
    return C.Config(model=C.ModelConfig(**kwargs))


def tiny_hifigan(hg):
    """A HiFi-GAN V1 structure at test size (hop 16, channels 32 -> 16 -> 8)
    from either package's ``vocoder.hifigan`` module."""
    return hg.HifiGanConfig(upsample_rates=(8, 2), upsample_kernel_sizes=(16, 4),
                            upsample_initial_channel=32)


def ffn_params(seed, C, F, k):
    """FFN-half weights in the JAX package's layouts (ops/pallas_ffn.py)."""
    g = np.random.default_rng(seed)
    ci = F // C
    f32 = np.float32
    return dict(
        wd=(g.standard_normal((k, C)) * 0.3).astype(f32),
        bd=(g.standard_normal((C,)) * 0.1).astype(f32),
        w1=(g.standard_normal((1, C, F)) * C ** -0.5).astype(f32),
        b1=(g.standard_normal((F,)) * 0.1).astype(f32),
        wg=(g.standard_normal((1, C, ci, ci)) * 0.5).astype(f32),
        bg=(g.standard_normal((F,)) * 0.1).astype(f32),
        w2=(g.standard_normal((1, F, C)) * F ** -0.5).astype(f32),
        b2=(g.standard_normal((C,)) * 0.1).astype(f32),
        g1=(1.0 + 0.1 * g.standard_normal((C,))).astype(f32),
        be1=(0.1 * g.standard_normal((C,))).astype(f32),
        g2=(1.0 + 0.1 * g.standard_normal((C,))).astype(f32),
        be2=(0.1 * g.standard_normal((C,))).astype(f32),
    )


def ffn_modules(p):
    """The same weights as the port's torch-layout parameter holders."""
    t = torch.from_numpy
    wg = p["wg"][0]                                   # (G, ci, co)
    G, ci, co = wg.shape
    ns = SimpleNamespace
    return dict(
        conv1_depth=ns(weight=t(p["wd"].T[:, None, :].copy()), bias=t(p["bd"])),
        conv1_point=ns(weight=t(p["w1"][0].T[:, :, None].copy()), bias=t(p["b1"])),
        conv2_group=ns(weight=t(np.transpose(wg, (0, 2, 1)).reshape(G * co, ci, 1).copy()),
                       bias=t(p["bg"])),
        conv2_point=ns(weight=t(p["w2"][0].T[:, :, None].copy()), bias=t(p["b2"])),
        norm1=ns(weight=t(p["g1"]), bias=t(p["be1"])),
        norm2=ns(weight=t(p["g2"]), bias=t(p["be2"])),
    )


def resblock_params(seed, C, k, dilations=(1, 3, 5), scale=1.0):
    """One ResBlock1 in the JAX tree layout ({convs1_i, convs2_i:
    {kernel (k, C, C), bias}}), weights ~ N(0, scale / (C k))."""
    g = np.random.default_rng(seed)
    p = {}
    for i in range(len(dilations)):
        for br in ("convs1", "convs2"):
            p[f"{br}_{i}"] = {
                "kernel": (g.standard_normal((k, C, C)) * scale * (C * k) ** -0.5
                           ).astype(np.float32),
                "bias": (g.standard_normal((C,)) * 0.1).astype(np.float32),
            }
    return p


def resblock_block(p, k, dilations=(1, 3, 5)):
    """A JAX ResBlock1 tree as ``prepare_resblock_weights`` input."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    convs = [
        (t(np.transpose(p[f"convs1_{i}"]["kernel"], (2, 1, 0))), t(p[f"convs1_{i}"]["bias"]),
         t(np.transpose(p[f"convs2_{i}"]["kernel"], (2, 1, 0))), t(p[f"convs2_{i}"]["bias"]))
        for i in range(len(dilations))
    ]
    return (k, tuple(dilations), convs)


_JAX_G2P = {}


def jax_neural_g2p(path=None, load=None):
    """The JAX package's ``NeuralG2P.load(path)`` (or ``load(path)``),
    loaded once per process (a model.init and, at first use, a decode
    compile: seconds on the CPU) and shared by the tests that hold the
    port's neural G2P against it."""
    from pathlib import Path

    from lightningfastspeech2_tpu.synthesis.neural_g2p import NeuralG2P

    if path is None:
        path = Path(__file__).resolve().parent.parent / "lightningfastspeech2_tpu/data/g2p_en.npz"
    key = str(Path(path).resolve())
    if key not in _JAX_G2P:
        _JAX_G2P[key] = (load or NeuralG2P.load)(path)
    return _JAX_G2P[key]


_TRAIN_SETUP = {}


def train_config(C, **train_kwargs):
    """``tiny_config`` for training on a ``make_corpus`` corpus: 256-dim
    d-vectors (the dataset's), every dropout rate 0, f32, warm-up 1 (lr 1e-4
    at the first update), batch 2, logged every step."""
    cfg = tiny_config(C, dvector_dim=256)
    m = cfg.model
    kwargs = {"train.bf16": False, "train.warmup_steps": 1, "train.batch_size": 2,
              "train.log_every": 1, "train.seed": 0}
    kwargs.update({f"train.{k}": v for k, v in train_kwargs.items()})
    return C.replace(cfg, **{
        "model.encoder": C.replace(m.encoder, dropout=0.0),
        "model.decoder": C.replace(m.decoder, dropout=0.0),
        "model.variance": C.replace(m.variance, dropouts=(0.0,) * len(m.variance.variances)),
        "model.duration": C.replace(m.duration, dropout=0.0),
        **kwargs})


def data_config(ds_module, cfg):
    """Either package's ``DataConfig`` for ``cfg``'s variances, with no
    duration augmentation (no draws from the dataset's generator)."""
    v = cfg.model.variance
    return ds_module.DataConfig(variances=v.variances, variance_levels=v.levels,
                                variance_transforms=v.transforms, augment_duration=0.0,
                                max_phones=cfg.model.max_phones,
                                max_frames=cfg.model.max_frames)


def seeded_params(shapes, seed, kernel_std=None):
    """Seeded numpy weights for a JAX tree of shapes (``jax.eval_shape`` of
    an init, which traces without compiling): kernels N(0, 1/fan_in) (or
    ``kernel_std``), LayerNorm scales 1 + N(0, 0.1), embeddings and biases
    N(0, 0.1); zero biases with ``kernel_std`` (the HiFi-GAN init)."""
    import jax

    g = np.random.default_rng(seed)

    def leaf(path, s):
        name = str(path[-1].key)
        if name == "kernel":
            std = kernel_std or np.prod(s.shape[:-1]) ** -0.5
            return (g.standard_normal(s.shape) * std).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * g.standard_normal(s.shape)).astype(np.float32)
        if name == "bias" and kernel_std is not None:
            return np.zeros(s.shape, np.float32)
        return (0.1 * g.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def jax_train_setup(tmp_path_factory):
    """A ``make_corpus`` corpus (2 speakers x 4 utterances, seed 0), the JAX
    package's dataset on it, the JAX model of ``train_config`` and seeded
    initial parameters (numpy), built once per process and shared by the
    tests that hold the port's training loop against the JAX package's."""
    if "setup" not in _TRAIN_SETUP:
        import jax
        import jax.numpy as jnp

        from lightningfastspeech2_tpu.core import config as JC
        from lightningfastspeech2_tpu.data import dataset as jds
        from lightningfastspeech2_tpu.train.loop import batch_iterator, build_model
        from lightningfastspeech2_tpu_torch.data.synthetic import make_corpus

        corpus = make_corpus(tmp_path_factory.mktemp("train_corpus"), n_speakers=2, n_utts=4,
                             seed=0)
        jcfg = train_config(JC)
        # the feature cache: items are extracted once, for the stats
        dataset = jds.TTSDataset(corpus, data_config(jds, jcfg),
                                 cache_dir=tmp_path_factory.mktemp("train_cache"))
        model = build_model(jcfg, dataset)
        first = next(batch_iterator(dataset, 2, seed=0))
        batch = {k: jnp.asarray(v) for k, v in first.items()}
        rngs = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
                "sdp": jax.random.PRNGKey(2)}
        # the tree's shapes traced, not compiled (an init compile takes
        # seconds), then seeded weights
        shapes = jax.eval_shape(lambda b: model.init(rngs, b, deterministic=True), batch)
        params = seeded_params(shapes["params"], 0)
        _TRAIN_SETUP["setup"] = SimpleNamespace(corpus=corpus, jcfg=jcfg, dataset=dataset,
                                                model=model, params=params)
    return _TRAIN_SETUP["setup"]


@contextlib.contextmanager
def recorded_jax_draws():
    """The JAX package's random draws, recorded in order: inside the block
    each value ``jax.random.normal``, ``uniform`` and ``randint`` return is
    appended (as numpy) to the yielded list, eagerly or, under jit and
    grad, through an ordered ``jax.debug.callback`` (program order; the
    list is complete once the block ends, after an effects barrier). The
    port is fed the same values in the same order (``models/draws.py
    HandedDraws``): flax's ``make_rng`` stream cannot be reproduced in
    torch. Nothing in the JAX package changes; the module attributes are
    restored on exit."""
    import jax

    draws = []
    names = ("normal", "uniform", "randint")
    originals = {n: getattr(jax.random, n) for n in names}

    def record(value):
        draws.append(np.asarray(value))

    def wrap(fn):
        def recorded(*args, **kwargs):
            out = fn(*args, **kwargs)
            jax.debug.callback(record, out, ordered=True)
            return out
        return recorded

    for n in names:
        setattr(jax.random, n, wrap(originals[n]))
    try:
        yield draws
        jax.effects_barrier()
    finally:
        for n in names:
            setattr(jax.random, n, originals[n])
