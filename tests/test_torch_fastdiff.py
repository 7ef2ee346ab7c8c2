"""The port's FastDiff serving path against the JAX package's.

- ``lvc_stack`` (on the CPU: ``lvc_stack_plain``) against the Pallas
  ``fused_lvc_stack`` in interpret mode, at the JAX tests' shape classes;
- the routing rule against the stages the JAX ``eps_apply_fused`` sends to
  its kernel (traced abstractly, with the kernel call recorded);
- the ε network against ``FastDiff.apply`` and ``eps_apply_fused``;
- the weight bridge, round trip through ``convert_fastdiff_state_dict``;
- ``FastDiffVocoder.inference`` with the JAX sampler's own noise injected;
- the sampler's generator and device, ``diffuse`` and ``schedule_probability``;
- the served slice: the acoustic model with the residual head and a tiny
  FastDiff through ``SpeechGenerator.generate_from_text``.

Inputs come from numpy seeds, weights cross through ``utils.convert``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightningfastspeech2_tpu.core import config as JC
from lightningfastspeech2_tpu.core.bucketing import Bucketer as JBucketer
from lightningfastspeech2_tpu.data.vocab import Vocab as JVocab
from lightningfastspeech2_tpu.models.fastspeech2 import (
    FastSpeech2 as JaxFastSpeech2,
    init_params,
    make_dummy_batch,
)
from lightningfastspeech2_tpu.models.joint import make_fastdiff_config as j_make_fastdiff_config
from lightningfastspeech2_tpu.models.joint import schedule_probability as j_schedule_probability
from lightningfastspeech2_tpu.ops import pallas_fastdiff
from lightningfastspeech2_tpu.synthesis.g2p import EnglishG2P as JG2P
from lightningfastspeech2_tpu.synthesis.generator import SpeechGenerator as JGenerator
from lightningfastspeech2_tpu.utils.torch_convert import convert_fastdiff_state_dict
from lightningfastspeech2_tpu.vocoder import diffusion as jdiff
from lightningfastspeech2_tpu.vocoder import fastdiff as jfd
from lightningfastspeech2_tpu_torch.core import config as TC
from lightningfastspeech2_tpu_torch.core.bucketing import Bucketer as TBucketer
from lightningfastspeech2_tpu_torch.data.vocab import Vocab as TVocab
from lightningfastspeech2_tpu_torch.models.fastspeech2 import build_fastspeech2
from lightningfastspeech2_tpu_torch.models.joint import make_fastdiff_config, schedule_probability
from lightningfastspeech2_tpu_torch.ops import fastdiff_lvc as tlvc
from lightningfastspeech2_tpu_torch.synthesis.g2p import EnglishG2P as TG2P
from lightningfastspeech2_tpu_torch.synthesis.generator import (
    FastDiffSynthesiser,
    SpeechGenerator as TGenerator,
)
from lightningfastspeech2_tpu_torch.utils.convert import from_jax_fastdiff, from_jax_fastspeech2
from lightningfastspeech2_tpu_torch.vocoder import diffusion as tdiff
from lightningfastspeech2_tpu_torch.vocoder import fastdiff as tfd
from tests.torch_port_helpers import tiny_config, torch_threads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _stack_inputs(seed, B, nL, hop, layers=4, C=32):
    """The JAX kernel tests' draws (tests/test_pallas_fastdiff.py)."""
    g = np.random.default_rng(seed)
    L = nL * hop
    return (g.normal(size=(B, L, C)), g.normal(size=(B, L, C)),
            g.normal(size=(B, nL, layers, C, 2 * C, 3)) * 0.2,
            g.normal(size=(B, nL, layers, 2 * C)) * 0.1,
            g.normal(size=(layers, 3, C, C)) * 0.1, g.normal(size=(layers, C)) * 0.1)


_STACK_CASES = [
    (64, 6, 4, False, False, 32),    # stage-2 class, tail tile
    (256, 4, 2, False, False, 32),   # stage-3 class
    (8, 24, 12, False, False, 32),   # stage-1 class: a halo of 6 frames
    (64, 6, 4, True, False, 32),     # Padé gate
    (64, 4, 4, False, True, 32),     # bf16 working dtype
    # inner widths the kernel takes besides 32 (FastDiffConfig.inner_channels)
    (64, 4, 4, False, False, 16),
    (64, 4, 4, False, True, 16),
    (64, 4, 4, False, False, 64),
    (64, 4, 4, False, True, 64),
    # past 128 (the card's wide route)
    (64, 4, 4, False, False, 192),
    (64, 4, 4, False, True, 192),
    (64, 4, 4, False, False, 256),
    (64, 4, 4, False, True, 256),
]


@pytest.mark.parametrize("hop,nL,tile_frames,fast,bf16,C", [
    pytest.param(*c, id="-".join(map(str, c[:5])) + ("" if c[5] == 32 else f"-C{c[5]}"))
    for c in _STACK_CASES])
def test_lvc_stack_matches_pallas_interpret(hop, nL, tile_frames, fast, bf16, C):
    x, ad, k, b, cw, cb = _stack_inputs(hop + nL, 2, nL, hop, C=C)
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    ref = pallas_fastdiff.fused_lvc_stack(
        jnp.asarray(x, jdt), jnp.asarray(ad, jdt), jnp.asarray(k, jdt),
        jnp.asarray(b, jnp.float32), jnp.asarray(cw, jdt), jnp.asarray(cb, jnp.float32), hop,
        fast_gating=fast, tile_frames=tile_frames, interpret=True)
    tdt = torch.bfloat16 if bf16 else torch.float32
    # the JAX side's inputs as it rounded them, then the port's wrapper: on
    # a CPU tensor it takes the plain version and launches nothing
    x, ad, k, cw = (np.asarray(jnp.asarray(a, jdt), np.float32) for a in (x, ad, k, cw))
    n = tlvc.lvc_stack.launches
    got = tlvc.lvc_stack(_t(x, tdt), _t(ad, tdt), _t(k, tdt), _t(b), _t(cw, tdt), _t(cb), hop,
                         fast_gating=fast)
    assert tlvc.lvc_stack.launches == n and got.dtype == tdt
    want = np.asarray(ref, np.float32)
    if bf16 and C > tlvc.MAX_CHANNELS:
        # the TPU kernel rounds at other points too (a quarter of values
        # differ at every width, 26 % at C = 64), and a carried flip grows
        # with the 3C-term sums: held in ulps of the chain's bound, within
        # the width's limit
        ulps, _ = tlvc.bf16_chain_error(got, _t(want), _t(x), _t(ad), k.shape[2])
        assert ulps <= tlvc.bf16_chain_limits(C)[0], ulps
    elif bf16:
        # bf16 residual carries (the JAX kernel test's tolerance)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0.1, atol=0.15)
    else:
        # f32: summation order only
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("C,gate_change", [
    pytest.param(C, change, id=str(change) + ("" if C == 32 else f"-C{C}"))
    for C in (32, 256) for change in (None, "+1e-3", "x0.5")])
def test_bf16_chain_check_rejects_a_wrong_gate(monkeypatch, C, gate_change):
    # the measure that holds lvc_stack in bf16 against its plain version on
    # the card, within the width's limits: a chain whose gate is off by
    # 1e-3, or by half its value, must fail it; the same chain passes with
    # nothing off (at C = 256 the wide route's limits)
    g = torch.Generator().manual_seed(9)
    hop, nL, layers = 64, 16, 4
    x, ad = (torch.randn(1, nL * hop, C, generator=g).to(torch.bfloat16) for _ in range(2))
    k = (0.2 * torch.randn(1, nL, layers, C, 2 * C, 3, generator=g)).to(torch.bfloat16)
    b = 0.1 * torch.randn(1, nL, layers, 2 * C, generator=g)
    cw = (0.1 * torch.randn(layers, 3, C, C, generator=g)).to(torch.bfloat16)
    cb = 0.1 * torch.randn(layers, C, generator=g)
    ref = tlvc.lvc_stack_plain(x, ad, k, b, cw, cb, hop)
    gate = tlvc.gated_activation
    if gate_change == "+1e-3":
        monkeypatch.setattr(tlvc, "gated_activation", lambda y, c, f: gate(y, c, f) + 1e-3)
    elif gate_change == "x0.5":
        monkeypatch.setattr(tlvc, "gated_activation", lambda y, c, f: gate(y, c, f) * 0.5)
    out = tlvc.lvc_stack_plain(x, ad, k, b, cw, cb, hop)
    ulps, share = tlvc.bf16_chain_error(out, ref, x, ad, layers)
    most_ulps, most_unequal = tlvc.bf16_chain_limits(C)
    agrees = ulps <= most_ulps and share <= most_unequal
    assert agrees == (gate_change is None), (ulps, share)


def _jax_routed_hops(cfg, n_frames, dtype):
    """The hops of the stages whose chain the JAX ``eps_apply_fused`` sends
    to ``fused_lvc_stack``, recorded while tracing it abstractly."""
    hops = []

    def record(h, audio_down, kernels, biases, conv_w, conv_b, hop, **kw):
        hops.append(hop)
        return h

    model = jfd.FastDiff(cfg)
    T = n_frames * cfg.hop_length
    x = jax.ShapeDtypeStruct((1, T), jnp.float32)
    c = jax.ShapeDtypeStruct((1, n_frames, cfg.cond_channels), jnp.float32)
    ts = jnp.asarray([5.0])
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 2 * cfg.hop_length), jnp.float32),
                            jax.ShapeDtypeStruct((1, 2, cfg.cond_channels), jnp.float32), ts)
    original = pallas_fastdiff.fused_lvc_stack
    pallas_fastdiff.fused_lvc_stack = record
    try:
        jax.eval_shape(lambda p, xx, cc: jfd.eps_apply_fused(p, cfg, xx, cc, ts, dtype=dtype),
                       params, x, c)
    finally:
        pallas_fastdiff.fused_lvc_stack = original
    return hops


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("opt_in", [False, True])
def test_routing_matches_the_jax_gate(monkeypatch, opt_in, bf16):
    if opt_in:
        monkeypatch.setenv("LFS2_FUSED_STAGE1", "1")
    else:
        monkeypatch.delenv("LFS2_FUSED_STAGE1", raising=False)
    cfg = jfd.FastDiffConfig()
    layers = cfg.lvc_layers_each_block
    assert tlvc.lvc_reach(layers) == 44
    seen = set()
    for n_frames in (3, 5, 6, 16, 512):
        want = _jax_routed_hops(cfg, n_frames, jnp.bfloat16 if bf16 else jnp.float32)
        hops, hop = [], 1
        for r in cfg.upsample_ratios:
            hop *= r
            if tlvc.routes_to_kernel(hop, n_frames, layers):
                hops.append(hop)
        assert hops == want, (n_frames, hops, want)
        seen.add(tuple(hops))
    # the cases cover both answers at stage 1 under the opt-in
    assert seen == ({(8, 64, 256), (64, 256)} if opt_in else {(64, 256)})


def _unit_gain_params(model, cfg, seed):
    """Parameters of the tree ``model.init`` would make, drawn from a numpy
    seed at unit gain: every kernel N(0, 1/fan_in), every bias N(0, 0.01),
    so each layer carries signal (the JAX init's N(0, 0.01) convs leave the
    output near zero)."""
    g = np.random.default_rng(seed)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 2 * cfg.hop_length), jnp.float32),
                            jax.ShapeDtypeStruct((1, 2, cfg.cond_channels), jnp.float32),
                            jax.ShapeDtypeStruct((1,), jnp.float32))

    def draw(path, leaf):
        if path[-1].key == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (g.standard_normal(leaf.shape) * fan_in ** -0.5).astype(np.float32)
        return (g.standard_normal(leaf.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _fastdiff_params(cfg, seed):
    model = jfd.FastDiff(cfg)
    return model, _unit_gain_params(model, cfg, seed)


@pytest.fixture(scope="module")
def reference_fastdiff():
    return _fastdiff_params(jfd.FastDiffConfig(), 0)


@pytest.mark.parametrize("Tc,inner,kpnet", [pytest.param(3, 32, 64, id="3"),
                                            pytest.param(16, 32, 64, id="16"),
                                            pytest.param(3, 64, 64, id="3-inner64"),
                                            pytest.param(3, 256, 8, id="3-inner256")])
def test_eps_network_matches_jax(reference_fastdiff, monkeypatch, Tc, inner, kpnet):
    # Tc 16 under the opt-in: every stage on the JAX kernel (interpret mode)
    # and on lvc_stack in the port; Tc 3 keeps stage 1 on the plain chain;
    # inner 64 and 256: a network trained with that many inner channels,
    # stages 2 and 3 on the JAX kernel at that C (256: the card's wide
    # route), at 256 with a kernel predictor of 8 hidden channels (at 64
    # its last convs alone hold 906M weights, 25 s of draws)
    if Tc == 16:
        monkeypatch.setenv("LFS2_FUSED_STAGE1", "1")
    cfg = jfd.FastDiffConfig(inner_channels=inner, kpnet_hidden_channels=kpnet)
    model, params = reference_fastdiff if inner == 32 else _fastdiff_params(cfg, 0)
    g = np.random.default_rng(4)
    x = g.normal(size=(2, Tc * cfg.hop_length)).astype(np.float32)
    c = g.normal(size=(2, Tc, cfg.cond_channels)).astype(np.float32)
    ts = np.asarray([3.25, 77.5], np.float32)
    args = (params, jnp.asarray(x), jnp.asarray(c), jnp.asarray(ts))
    ref = np.asarray(jax.jit(model.apply)(*args))
    fused = np.asarray(jax.jit(lambda p, xx, cc, tt: jfd.eps_apply_fused(
        p, cfg, xx, cc, tt, dtype=jnp.float32, interpret=True))(*args))
    port = tfd.FastDiff(tfd.FastDiffConfig(inner_channels=inner, kpnet_hidden_channels=kpnet))
    port.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                          for k, v in from_jax_fastdiff(params).items()})
    with torch.no_grad():
        got = port(_t(x), _t(c), _t(ts)).numpy()
    assert got.shape == ref.shape and np.abs(ref).max() > 0.1
    # f32: summation order only (the JAX kernel test's tolerance)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, fused, rtol=2e-4, atol=2e-4)


def test_weight_bridge_round_trip(reference_fastdiff):
    _, params = reference_fastdiff
    state = from_jax_fastdiff(params)
    port = tfd.FastDiff(tfd.FastDiffConfig())
    assert set(state) == set(port.state_dict())
    back = convert_fastdiff_state_dict(state)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat) == len(flat_back)
    for path, leaf in flat:
        got = np.asarray(flat_back[path])
        assert got.dtype == leaf.dtype and np.array_equal(got, leaf), path


# a small FastDiff: hop 16 over three stages, two LVC layers (reach 6), so
# the last stage (hop 16) takes the kernel route and the first two the chain
SMALL = dict(inner_channels=8, upsample_ratios=(2, 2, 4), lvc_layers_each_block=2,
             kpnet_hidden_channels=16, step_embed_dim_in=32, step_embed_dim_mid=64,
             step_embed_dim_out=64)


def _jax_noise(rng, shape, N):
    """The JAX sampler's draws: x_T, then one normal per step from
    split(fold_in(rng, 1), N)."""
    keys = jax.random.split(jax.random.fold_in(rng, 1), N)
    return (np.asarray(jax.random.normal(rng, shape)),
            np.stack([np.asarray(jax.random.normal(k, shape)) for k in keys]))


@pytest.mark.parametrize("N", [3, 4])
def test_vocoder_inference_matches_jax(N):
    jcfg, tcfg = jfd.FastDiffConfig(**SMALL), tfd.FastDiffConfig(**SMALL)
    _, params = _fastdiff_params(jcfg, 1)
    jvoc = jfd.FastDiffVocoder(jcfg, params=params, fused=False)
    tvoc = tfd.FastDiffVocoder(tcfg, from_jax_fastdiff(params, tcfg), device="cpu")
    mel = np.random.default_rng(N).normal(size=(2, 6, 80)).astype(np.float32)
    rng = jax.random.PRNGKey(7)
    ref = np.asarray(jvoc.inference(jnp.asarray(mel), N=N, rng=rng))
    x_T, noises = _jax_noise(rng, (2, 6 * 16), N)
    got = tvoc.inference(mel, N=N, x_T=x_T, noises=noises).numpy()
    assert got.shape == ref.shape == (2, 96)
    assert np.isclose(np.abs(got).max(axis=-1), 1.0).all()
    # f32 through N passes; peak-normalised
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_ddim_sampler_and_step_embedding_match_jax():
    sched = jdiff.make_inference_schedule(
        jdiff.compute_hyperparams(jdiff.linear_beta_schedule()), 4)
    eps = lambda x, ts: x * 0.5 + ts[:, None] * 1e-3
    ref = jdiff.reverse_sample(eps, (2, 32), sched, jax.random.PRNGKey(0), ddim=True)
    x_j = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (2, 32)))
    got = tdiff.reverse_sample(eps, (2, 32), sched, ddim=True, x_T=x_j, device="cpu")
    assert np.isfinite(np.asarray(ref)).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    # step embeddings of fractional steps: sin and cos of arguments up to
    # 1000, where one f32 ulp is 6e-5, so the two libraries' f32 sin differ
    # by up to about that
    ts = np.asarray([0.0, 3.25, 999.5], np.float32)
    np.testing.assert_allclose(tdiff.step_embedding(_t(ts), 128).numpy(),
                               np.asarray(jdiff.step_embedding(jnp.asarray(ts), 128)),
                               rtol=0, atol=1e-4)


def test_reverse_sample_draws_from_the_given_generator():
    # x_T first, then the (N, *shape) step noises, from the one generator;
    # on the device asked for, cuda unless the caller asks for the CPU
    sched = tdiff.make_inference_schedule(
        tdiff.compute_hyperparams(tdiff.linear_beta_schedule()), 4)
    eps = lambda x, ts: x * 0.5 + ts[:, None] * 1e-3
    g = torch.Generator().manual_seed(5)
    x_T, noises = torch.randn(2, 32, generator=g), torch.randn(4, 2, 32, generator=g)
    got = tdiff.reverse_sample(eps, (2, 32), sched, torch.Generator().manual_seed(5),
                               device="cpu")
    want = tdiff.reverse_sample(eps, (2, 32), sched, x_T=x_T, noises=noises)
    assert torch.equal(got, want) and got.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tdiff.reverse_sample(eps, (2, 32), sched)


def test_diffuse_matches_jax():
    hp = jdiff.compute_hyperparams(jdiff.linear_beta_schedule())
    g = np.random.default_rng(6)
    x0, z = (g.normal(size=(3, 2, 40)).astype(np.float32) for _ in range(2))
    ts = np.asarray([0, 517, 999])
    alpha = np.asarray(hp.alpha, np.float32)
    ref = jdiff.diffuse(jnp.asarray(x0), jnp.asarray(ts), jnp.asarray(z), jnp.asarray(alpha))
    got = tdiff.diffuse(_t(x0), torch.as_tensor(ts), _t(z), _t(alpha))
    # f32 elementwise: one rounding of the sqrt and the two products apart
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("schedule,end", [((0.0, 1.0), 20), ((0.1, 0.3, 0.5, 0.9), 3)])
def test_schedule_probability_matches_jax(schedule, end):
    jm = JC.ModelConfig(fastdiff_schedule=schedule, fastdiff_schedule_end=end)
    tm = TC.ModelConfig(fastdiff_schedule=schedule, fastdiff_schedule_end=end)
    for epoch in range(end + 3):
        assert schedule_probability(tm, epoch) == j_schedule_probability(jm, epoch), epoch


SENTENCE = "hello world, this is a test."
HOP = 16
FD_MODEL = dict(fastdiff_vocoder=True, fastdiff_upsample_ratios=(2, 2, 4), fastdiff_lvc_layers=2,
                fastdiff_inner_channels=8, fastdiff_kpnet_hidden=16)


@pytest.fixture(scope="module")
def fastdiff_generators():
    jcfg = tiny_config(JC, audio=JC.AudioConfig(hop_length=HOP), **FD_MODEL)
    tcfg = tiny_config(TC, audio=TC.AudioConfig(hop_length=HOP), **FD_MODEL)
    model = JaxFastSpeech2(jcfg.model, use_fastdiff_head=True)
    dummy = {k: jnp.asarray(v) for k, v in
             make_dummy_batch(jcfg.model, batch_size=1, n_phones=8, seed=0).items()}
    params = jax.tree_util.tree_map(np.array, init_params(model, jax.random.PRNGKey(0), dummy))
    assert "fastdiff_linear1" in params["params"]
    head = params["params"]["variance_adaptor"]["duration_predictor"]["linear"]
    head["kernel"][:] = 0.0
    head["bias"][:] = np.log(8.0)      # every phone 7 frames

    fd_cfg = j_make_fastdiff_config(jcfg.model)
    _, fd_params = _fastdiff_params(fd_cfg, 2)
    jvoc = jfd.FastDiffVocoder(fd_cfg, params=fd_params, fused=False)
    n_steps = jcfg.model.fastdiff_inference_steps

    def jax_synthesiser(mel):
        # cli/generate.py's --use_fastdiff closure (rng PRNGKey(0) per call)
        wav = np.asarray(jvoc.inference(np.asarray(mel)[None], N=n_steps))
        return wav[0] * 32768.0

    phones = sorted(set(JG2P()(SENTENCE)))
    dvecs = {f"spk{i}": np.random.default_rng(i).standard_normal(16).astype(np.float32)
             for i in range(2)}
    jgen = JGenerator(jcfg, model, params["params"], JVocab(phones), JG2P(),
                      synthesiser=jax_synthesiser, speaker2dvector=dvecs)
    tfd_cfg = make_fastdiff_config(tcfg.model)
    synth = FastDiffSynthesiser(
        tcfg.model, from_jax_fastdiff(fd_params, tfd_cfg), device="cpu",
        noise_source=lambda shape, N: _jax_noise(jax.random.PRNGKey(0), shape, N))
    tmodel = build_fastspeech2(tcfg.model, device="cpu", use_fastdiff_head=True,
                               state_dict=from_jax_fastspeech2(params, tcfg.model))
    tgen = TGenerator(tcfg, tmodel, TVocab(phones), TG2P(), synthesiser=synth,
                      speaker2dvector=dvecs)
    jgen.bucketer = JBucketer(jcfg.model.max_phones, jcfg.model.max_frames, frame_step=16)
    tgen.bucketer = TBucketer(tcfg.model.max_phones, tcfg.model.max_frames, frame_step=16)
    return jgen, tgen, model, params


def test_residual_head_matches_jax(fastdiff_generators):
    jgen, tgen, model, params = fastdiff_generators
    ids = tgen.text_to_ids(SENTENCE)
    batch = {"phones": np.pad(ids, (0, 32 - len(ids)))[None].astype(np.int32),
             "speaker": tgen.speaker2dvector["spk1"][None]}
    ref = jax.jit(lambda p, b: model.apply(p, b, inference=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got = tgen.model({k: torch.as_tensor(v) for k, v in batch.items()}, inference=True)
    want = np.asarray(ref["fastdiff_var"])
    assert got["fastdiff_var"].shape == want.shape and np.abs(want).max() > 1e-3
    # f32 through two models; XLA and torch sum in other orders
    np.testing.assert_allclose(got["fastdiff_var"].numpy(), want, rtol=0, atol=1e-5)


def test_fastdiff_generate_from_text_matches_jax(fastdiff_generators):
    jgen, tgen, _, _ = fastdiff_generators
    ref = jgen.generate_from_text(SENTENCE, speaker="spk0", seed=3)
    out = tgen.generate_from_text(SENTENCE, speaker="spk0", seed=3)
    assert out.dtype == np.float32 and out.ndim == 1
    assert len(out) == len(ref) == 7 * HOP * len(tgen.text_to_ids(SENTENCE))
    assert np.isfinite(out).all() and np.abs(ref).max() > 0.05
    # f32 end to end: acoustic model, residual head, four FastDiff passes
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
