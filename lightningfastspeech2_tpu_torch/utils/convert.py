"""JAX-package parameter trees -> the port's state dicts.

The inverse of ``lightningfastspeech2_tpu/utils/torch_convert.py``
(``convert_fastspeech2_state_dict`` and ``convert_fastdiff_state_dict``)
and of
``lightningfastspeech2_tpu/vocoder/hifigan.py`` (``convert_torch_state_dict``):
the input is the JAX package's parameter tree as nested dicts of numpy
arrays (with or without the top-level ``"params"`` key), the output a
``{name: np.ndarray}`` state dict for the port's modules. Imports neither
JAX nor the JAX package.

Layouts: Dense kernel (in, out) -> Linear (out, in); Conv kernel
(k, in, out) -> Conv1d (out, in, k), grouped (k, in/g, out) -> (out,
in/g, k); 2-D Conv kernel (kh, kw, in, out) -> Conv2d (out, in, kh, kw);
depthwise (k, 1, C) -> (C, 1, k);
grouped (k, G, ci, co) -> (G*co, ci, k); LayerNorm scale -> weight;
packed qkv kernel (H, 3H) -> in_proj_weight (3H, H); transposed-conv
kernel (k, in, out) -> ConvTranspose1d (in, out, k), a plain transpose
(the JAX conv_transpose1d flips the taps itself).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Mapping, Sequence

import numpy as np
import torch

from lightningfastspeech2_tpu_torch.core.config import ModelConfig
from lightningfastspeech2_tpu_torch.vocoder.fastdiff import FastDiffConfig
from lightningfastspeech2_tpu_torch.vocoder.hifigan import HifiGanConfig

State = Dict[str, np.ndarray]


def _tree(params: Mapping[str, Any]) -> Mapping[str, Any]:
    return params["params"] if "params" in params else params


def _linear(out: State, name: str, p: Mapping[str, Any]) -> None:
    out[f"{name}.weight"] = np.asarray(p["kernel"]).T
    out[f"{name}.bias"] = np.asarray(p["bias"])


def _conv(out: State, name: str, p: Mapping[str, Any]) -> None:
    out[f"{name}.weight"] = np.transpose(np.asarray(p["kernel"]), (2, 1, 0))
    out[f"{name}.bias"] = np.asarray(p["bias"])


def _layernorm(out: State, name: str, p: Mapping[str, Any]) -> None:
    out[f"{name}.weight"] = np.asarray(p["scale"])
    out[f"{name}.bias"] = np.asarray(p["bias"])


def _grouped(out: State, name: str, p: Mapping[str, Any]) -> None:
    k, G, ci, co = np.asarray(p["kernel"]).shape
    w = np.transpose(np.asarray(p["kernel"]), (1, 3, 2, 0))  # (G, co, ci, k)
    out[f"{name}.weight"] = w.reshape(G * co, ci, k)
    out[f"{name}.bias"] = np.asarray(p["bias"])


def _fft_stack(out: State, prefix: str, tree: Mapping[str, Any], layers: int) -> None:
    """Each layer's attention, norms and FFN: the depthwise-separable
    ConvFFN, the plain one (``conv1``, ``conv2``) or the linear FFN
    (``LinearFFN_0``: ``linear1``, ``linear2``), whichever the tree has."""
    for i in range(layers):
        p, lp = f"{prefix}.layers.{i}", tree[f"layer{i}"]
        att = lp["SelfAttention_0"]
        out[f"{p}.self_attn.in_proj_weight"] = np.asarray(att["qkv"]["kernel"]).T
        out[f"{p}.self_attn.in_proj_bias"] = np.asarray(att["qkv"]["bias"])
        _linear(out, f"{p}.self_attn.out_proj", att["out"])
        _layernorm(out, f"{p}.norm1", lp["norm1"])
        _layernorm(out, f"{p}.norm2", lp["norm2"])
        if "LinearFFN_0" in lp:
            _linear(out, f"{p}.linear1", lp["LinearFFN_0"]["Dense_0"])
            _linear(out, f"{p}.linear2", lp["LinearFFN_0"]["Dense_1"])
            continue
        ffn = lp["ConvFFN_0"]
        if "conv1" in ffn:
            _conv(out, f"{p}.conv1", ffn["conv1"])
            _conv(out, f"{p}.conv2", ffn["conv2"])
            continue
        _conv(out, f"{p}.conv1.0", ffn["conv1_depth"])
        _conv(out, f"{p}.conv1.1", ffn["conv1_point"])
        _grouped(out, f"{p}.conv2.0", ffn["conv2_group"])
        _conv(out, f"{p}.conv2.1", ffn["conv2_point"])


def _variance_predictor(out: State, prefix: str, tree: Mapping[str, Any],
                        nlayers: int, depthwise: bool) -> None:
    for i in range(nlayers):
        p, lp = f"{prefix}.layers.{i}", tree[f"conv{i}"]
        if depthwise:
            _conv(out, f"{p}.layers.0.module.0", lp["depth"])
            _conv(out, f"{p}.layers.0.module.1", lp["point"])
        else:
            _conv(out, f"{p}.layers.0.module", lp["conv"])
        _layernorm(out, f"{p}.layers.2", lp["LayerNorm_0"])
    _linear(out, f"{prefix}.linear", tree["linear"])


def _conv1x1(out: State, name: str, p: Mapping[str, Any]) -> None:
    """A Dense (in, out) -> a 1x1 Conv1d (out, in, 1)."""
    out[f"{name}.weight"] = np.asarray(p["kernel"]).T[:, :, None]
    out[f"{name}.bias"] = np.asarray(p["bias"])


def _dds_conv(out: State, prefix: str, tree: Mapping[str, Any], layers: int = 3) -> None:
    for i in range(layers):
        out[f"{prefix}.convs_sep.{i}.weight"] = np.transpose(
            np.asarray(tree[f"sep{i}_kernel"]), (2, 1, 0))
        out[f"{prefix}.convs_sep.{i}.bias"] = np.asarray(tree[f"sep{i}_bias"])
        _conv1x1(out, f"{prefix}.convs_1x1.{i}", tree[f"conv1x1_{i}"])
        for which in (1, 2):
            ln = tree[f"norm{which}_{i}"]
            out[f"{prefix}.norms_{which}.{i}.gamma"] = np.asarray(ln["scale"])
            out[f"{prefix}.norms_{which}.{i}.beta"] = np.asarray(ln["bias"])


def _sdp(out: State, prefix: str, tree: Mapping[str, Any], n_flows: int) -> None:
    """``models/sdp.py StochasticDurationPredictor``: the encoders, then
    ``flow_pre`` / ``flow_{i}`` as ``flows.0`` / ``flows.{i + 1}`` (and the
    ``post_`` twins)."""
    for side in ("", "post_"):
        _conv1x1(out, f"{prefix}.{side}pre", tree[f"{side}pre"])
        _dds_conv(out, f"{prefix}.{side}convs", tree[f"{side}convs"])
        _conv1x1(out, f"{prefix}.{side}proj", tree[f"{side}proj"])
        ea = tree[f"{side}flow_pre"]
        for k in ("translation", "log_scale"):
            out[f"{prefix}.{side}flows.0.{k}"] = np.asarray(ea[k])[:, None]
        for i in range(n_flows):
            p, f = f"{prefix}.{side}flows.{i + 1}", tree[f"{side}flow_{i}"]
            _conv1x1(out, f"{p}.pre", f["pre"])
            _dds_conv(out, f"{p}.convs", f["convs"])
            _conv1x1(out, f"{p}.proj", f["proj"])


def _step_mlp(out: State, prefix: str, tree: Mapping[str, Any]) -> None:
    for name in ("fc_t1", "fc_t2", "linear_noise"):
        _linear(out, f"{prefix}.{name}", tree[name])


def _diffusion_adaptor(out: State, prefix: str, tree: Mapping[str, Any],
                       cfg: ModelConfig) -> None:
    """``models/fastdiff_variances.py FastDiffVarianceAdaptor``."""
    v = cfg.variance

    def predictor(p, t, nlayers):
        _step_mlp(out, p, t)
        _linear(out, f"{p}.linear_in", t["linear_in"])
        _variance_predictor(out, p, t, nlayers, v.depthwise)

    predictor(f"{prefix}.duration_predictor", tree["duration_predictor"], cfg.duration.nlayers)
    for i, var in enumerate(v.variances):
        predictor(f"{prefix}.predictors.{var}", tree[f"predictor_{var}"], v.nlayers[i])
        out[f"{prefix}.embeddings.{var}.weight"] = np.asarray(
            tree[f"embedding_{var}"]["embedding"])


def _speaker_generator(out: State, prefix: str, tree: Mapping[str, Any]) -> None:
    """``models/fastdiff_variances.py FastDiffSpeakerGenerator``."""
    p, sg = f"{prefix}.predictor", tree["predictor"]
    _step_mlp(out, p, sg)
    for name in ("conditional_in", "mlp0", "mlp1", "linear_out"):
        _linear(out, f"{p}.{name}", sg[name])


def from_jax_fastspeech2(params: Mapping[str, Any], cfg: ModelConfig) -> State:
    """The JAX ``FastSpeech2`` tree -> the port's ``FastSpeech2`` state dict
    (the stochastic duration predictor, the diffusion adaptor and speaker
    generator included where the config has them)."""
    t = _tree(params)
    out: State = {"phone_embedding.weight": np.asarray(t["phone_embedding"]["embedding"])}
    _fft_stack(out, "encoder", t["encoder"], cfg.encoder.layers)
    _fft_stack(out, "decoder", t["decoder"], cfg.decoder.layers)
    _linear(out, "linear", t["mel_head"])
    if cfg.speaker_type == "dvector":
        _linear(out, "speaker_embedding.projection", t["speaker_embedding"]["projection"])
    elif cfg.speaker_type == "id":
        out["speaker_embedding.speaker_embedding.weight"] = np.asarray(
            t["speaker_embedding"]["embedding"]["embedding"])
    for prior in cfg.priors:
        out[f"prior_embeddings.{prior}.embedding.weight"] = np.asarray(
            t[f"prior_embedding_{prior}"]["embedding"]["embedding"])
    if "fastdiff_speaker_generator" in t:
        _speaker_generator(out, "fastdiff_speaker_generator", t["fastdiff_speaker_generator"])
    va = t["variance_adaptor"]
    if cfg.fastdiff_variances:
        _diffusion_adaptor(out, "variance_adaptor", va, cfg)
    elif cfg.duration.stochastic:
        _sdp(out, "variance_adaptor.duration_predictor", va["duration_predictor"],
             cfg.duration.nlayers)
    else:
        _variance_predictor(out, "variance_adaptor.duration_predictor",
                            va["duration_predictor"], cfg.duration.nlayers,
                            cfg.duration.depthwise)
    for i, var in enumerate(() if cfg.fastdiff_variances else cfg.variance.variances):
        p, enc = f"variance_adaptor.encoders.{var}", va[f"encoder_{var}"]
        _variance_predictor(out, f"{p}.predictor", enc["predictor"],
                            cfg.variance.nlayers[i], cfg.variance.depthwise)
        out[f"{p}.embedding.weight"] = np.asarray(enc["embedding"]["embedding"])
        if cfg.variance.transforms[i] == "cwt":
            _linear(out, f"{p}.mean_std_linear", enc["mean_std_linear"])
    if "fastdiff_linear1" in t:
        _linear(out, "fastdiff_linear.0", t["fastdiff_linear1"])
        _linear(out, "fastdiff_linear.1", t["fastdiff_linear2"])
    return out


def from_jax_hifigan(params: Mapping[str, Any],
                     cfg: HifiGanConfig = HifiGanConfig()) -> State:
    """The JAX HiFi-GAN ``Generator`` tree -> the port's ``Generator``
    state dict (ResBlock1 and ResBlock2 configs)."""
    t = _tree(params)
    out: State = {}
    _conv(out, "conv_pre", t["conv_pre"])
    _conv(out, "conv_post", t["conv_post"])
    n_up, n_k = len(cfg.upsample_rates), len(cfg.resblock_kernel_sizes)
    for i in range(n_up):
        out[f"ups.{i}.weight"] = np.transpose(np.asarray(t[f"ups_{i}"]["kernel"]), (1, 2, 0))
        out[f"ups.{i}.bias"] = np.asarray(t[f"ups_{i}"]["bias"])
    branches = ("convs1", "convs2") if cfg.resblock == "1" else ("convs",)
    for rb in range(n_up * n_k):
        block = t[f"resblocks_{rb}"]
        for j in range(len(cfg.resblock_dilation_sizes[rb % n_k])):
            for branch in branches:
                _conv(out, f"resblocks.{rb}.{branch}.{j}", block[f"{branch}_{j}"])
    return out


def from_jax_discriminators(params: Mapping[str, Any]) -> State:
    """The JAX ``Discriminators`` tree (``vocoder/hifigan_train.py``: mpd's
    period{p} and msd's scale{i}, each conv{i} and conv_post) -> the port's
    ``Discriminators`` state dict."""
    t = _tree(params)
    out: State = {}
    for group, subs in (("mpd", t["mpd"]), ("msd", t["msd"])):
        for sub, tree in subs.items():
            prefix = f"{group}.discs.{sub}"
            for name, p in tree.items():
                key = f"{prefix}.conv_post" if name == "conv_post" else f"{prefix}.convs.{name[4:]}"
                kernel = np.asarray(p["kernel"])
                # (kh, kw, in, out) -> (out, in, kh, kw); (k, in/g, out) -> (out, in/g, k)
                axes = (3, 2, 0, 1) if kernel.ndim == 4 else (2, 1, 0)
                out[f"{key}.weight"] = np.ascontiguousarray(np.transpose(kernel, axes))
                out[f"{key}.bias"] = np.asarray(p["bias"])
    return out


def _truncated_normal(n: int, generator: torch.Generator) -> torch.Tensor:
    """n standard normal draws truncated to [-2, 2], each one outside drawn
    again until it falls inside (on the CPU)."""
    w = torch.randn(n, generator=generator)
    idx = torch.nonzero(w.abs() > 2.0).squeeze(1)
    while idx.numel():
        w[idx] = torch.randn(idx.numel(), generator=generator)
        idx = idx[w[idx].abs() > 2.0]
    return w


@torch.no_grad()
def init_discriminator_weights(d: torch.nn.Module, generator: torch.Generator) -> None:
    """flax's ``nn.Conv`` init on every conv of ``d``: LeCun normal (a
    normal of std sqrt(1 / fan_in), fan_in = in/g times the kernel's taps,
    truncated at two standard deviations and rescaled to keep that
    variance) and zero biases, drawn on the CPU from ``generator``, so that
    a card and the CPU draw alike. flax's own draws cannot be reproduced."""
    for m in d.modules():
        if isinstance(m, (torch.nn.Conv1d, torch.nn.Conv2d)):
            lecun_normal_(m.weight, m.weight[0].numel(), generator)
            m.bias.zero_()


@torch.no_grad()
def lecun_normal_(weight: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax's LeCun normal in place: a normal of std sqrt(1 / fan_in),
    truncated at two standard deviations and rescaled to keep that
    variance, drawn on the CPU from ``generator``."""
    # the std of a standard normal truncated to [-2, 2]
    # (jax.nn.initializers.variance_scaling's constant)
    trunc_std = 0.87962566103423978
    w = _truncated_normal(weight.numel(), generator).reshape(weight.shape)
    weight.copy_(w * (math.sqrt(1.0 / fan_in) / trunc_std))


# the convs of KernelPredictor.residual_conv at the reference's Sequential
# indices (Dropout and LeakyReLU between them)
FASTDIFF_RESIDUAL_CONV_INDICES = (1, 3, 6, 8, 11, 13)


def from_jax_fastdiff(params: Mapping[str, Any],
                      cfg: FastDiffConfig = FastDiffConfig()) -> State:
    """The JAX ``FastDiff`` tree -> the port's ``FastDiff`` state dict (the
    reference torch names, weight norm folded)."""
    t = _tree(params)
    out: State = {}
    _conv(out, "first_audio_conv", t["first_audio_conv"])
    _conv(out, "final_conv.0", t["final_conv"])
    _linear(out, "fc_t1", t["fc_t1"])
    _linear(out, "fc_t2", t["fc_t2"])
    n_blocks = len(cfg.upsample_ratios)
    for i in range(n_blocks):
        db = t[f"downsample_{i}"]
        _conv(out, f"downsample.{i}.residual_dense", db["residual_dense"])
        for j in range(3):
            _conv(out, f"downsample.{i}.conv.{j}", db[f"conv_{j}"])
    for n in range(n_blocks):
        p, blk = f"lvc_blocks.{n}", t[f"lvc_blocks_{n}"]
        kp = blk["kernel_predictor"]
        _conv(out, f"{p}.kernel_predictor.input_conv.0", kp["input_conv"])
        for k, idx in enumerate(FASTDIFF_RESIDUAL_CONV_INDICES):
            _conv(out, f"{p}.kernel_predictor.residual_conv.{idx}", kp[f"residual_conv_{k}"])
        _conv(out, f"{p}.kernel_predictor.kernel_conv", kp["kernel_conv"])
        _conv(out, f"{p}.kernel_predictor.bias_conv", kp["bias_conv"])
        _linear(out, f"{p}.fc_t", blk["fc_t"])
        out[f"{p}.upsample.weight"] = np.transpose(np.asarray(blk["upsample"]["kernel"]), (1, 2, 0))
        out[f"{p}.upsample.bias"] = np.asarray(blk["upsample"]["bias"])
        for j in range(cfg.lvc_layers_each_block):
            _conv(out, f"{p}.convs.{j}", blk[f"conv_{j}"])
    return out


def from_jax_dvector(params: Mapping[str, Any], num_layers: int = 3) -> State:
    """The JAX package's d-vector tree (``data/dvector.py DVector``) -> the
    port's ``DVector`` state dict, the inverse of its
    ``convert_torch_state_dict``: each layer's flax gate kernels ``i{g}``
    (input) and ``h{g}`` (hidden, with the bias), g in (i, f, g, o), stack
    into ``weight_ih_l{l}`` / ``weight_hh_l{l}``; the bias goes to
    ``bias_ih_l{l}`` and ``bias_hh_l{l}`` is 0 (torch adds the two)."""
    tree = _tree(params)
    out: State = {}
    for l in range(num_layers):
        cell = tree[f"lstm{l}"]["cell"]
        gates = ("i", "f", "g", "o")
        out[f"lstm.weight_ih_l{l}"] = np.concatenate(
            [np.asarray(cell[f"i{g}"]["kernel"]).T for g in gates])
        out[f"lstm.weight_hh_l{l}"] = np.concatenate(
            [np.asarray(cell[f"h{g}"]["kernel"]).T for g in gates])
        out[f"lstm.bias_ih_l{l}"] = np.concatenate(
            [np.asarray(cell[f"h{g}"]["bias"]) for g in gates])
        out[f"lstm.bias_hh_l{l}"] = np.zeros_like(out[f"lstm.bias_ih_l{l}"])
    _linear(out, "embedding", tree["embedding"])
    _linear(out, "attention", tree["attention"])
    return out


def _sorted_leaves(tree: Any) -> List[np.ndarray]:
    """The leaves of a tree of nested dicts in the order
    ``jax.tree_util.tree_leaves`` gives them (each dict's keys sorted)."""
    if isinstance(tree, Mapping):
        return [leaf for k in sorted(tree) for leaf in _sorted_leaves(tree[k])]
    return [np.asarray(tree)]


def _unflatten_sorted(tree: Any, leaves: List[np.ndarray]) -> Any:
    """``tree``'s structure with ``leaves`` (consumed from the front, in
    ``_sorted_leaves`` order) in place of its own."""
    if isinstance(tree, Mapping):
        return {k: _unflatten_sorted(tree[k], leaves) for k in sorted(tree)}
    leaf = np.asarray(leaves.pop(0))
    if leaf.shape != np.shape(tree):
        raise ValueError(f"a leaf of shape {leaf.shape} where the tree has {np.shape(tree)}")
    return leaf


def adamw_state_from_optax(leaves: Any, params: Mapping[str, Any],
                           to_state: Callable[[Mapping[str, Any]], State],
                           names: Sequence[str]) -> Dict[str, Any]:
    """The state of ``optax.adamw(schedule)`` over the JAX tree ``params``,
    saved as its flat leaf list (Adam's count, the first moments, the
    second moments, the schedule's count; a dict keyed "0", "1", ... as
    orbax may restore a list), as a ``torch.optim.AdamW.state_dict()``
    over the port's parameters ``names`` in the optimizer's order.

    The moments are rebuilt against ``params`` and mapped by ``to_state``,
    the mapping that carries the weights (``from_jax_hifigan``, ...),
    since a moment has its parameter's layout. The mapping is first run on
    a tree of element indices, which must come out a permutation of them:
    it may only move and reshape elements. Each parameter's ``step`` is the
    count, which also drives the port's learning-rate schedule
    (``vocoder/hifigan_train.py scheduled_lr``). The param group's
    hyperparameters are torch's defaults: the trainer that loads the state
    sets its own, as an optax optimizer's come from the code that runs it."""
    if isinstance(leaves, Mapping):
        leaves = [leaves[k] for k in sorted(leaves, key=int)]
    leaves = [np.asarray(l) for l in leaves]
    shapes = _sorted_leaves(params)
    n = len(shapes)
    if len(leaves) != 2 * n + 2:
        raise ValueError(f"{len(leaves)} optimizer leaves for {n} parameters; "
                         "optax.adamw holds 2 n + 2")
    count, sched = int(leaves[0]), int(leaves[-1])
    if count != sched:
        raise ValueError(f"Adam's count {count} and the schedule's {sched} differ")
    sizes = np.cumsum([0] + [a.size for a in shapes])
    index = to_state(_unflatten_sorted(
        params, [np.arange(o, o + a.size).reshape(a.shape) for o, a in zip(sizes, shapes)]))
    moved = np.sort(np.concatenate([np.asarray(v).reshape(-1) for v in index.values()]))
    if not np.array_equal(moved, np.arange(sizes[-1])):
        raise ValueError("the weight mapping does more than move and reshape elements")
    if set(index) != set(names):
        raise ValueError(f"the mapping names {sorted(set(index) ^ set(names))} "
                         "on one side only")
    mu = np.concatenate([a.reshape(-1) for a in leaves[1:n + 1]])
    nu = np.concatenate([a.reshape(-1) for a in leaves[n + 1:2 * n + 1]])
    template = torch.optim.AdamW([torch.nn.Parameter(torch.empty(0)) for _ in names])
    group = template.state_dict()["param_groups"][0]
    state = {i: {"step": torch.tensor(float(count)),
                 "exp_avg": torch.from_numpy(np.ascontiguousarray(mu[index[name]])),
                 "exp_avg_sq": torch.from_numpy(np.ascontiguousarray(nu[index[name]]))}
             for i, name in enumerate(names)}
    return {"state": state, "param_groups": [group]}
