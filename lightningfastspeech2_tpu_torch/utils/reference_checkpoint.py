"""Reference checkpoints (the torch litfass ``.ckpt`` and a FastDiff state
dict) as the port's state dicts.

Counterpart of ``load_reference_checkpoint`` and
``convert_fastdiff_state_dict`` in
``lightningfastspeech2_tpu/utils/torch_convert.py``. The port's modules
carry the reference's names and PyTorch layouts, so nothing is renamed or
transposed here: a leading ``model.`` is dropped, weight-norm pairs are
folded (``vocoder/hifigan.py fold_weight_norm_state``) and the keys are
held to the module's.

A reference ``.ckpt`` is a torch pickle whose sidecar entries may be any
Python object (the GMMs are scikit-learn's), so it is read with
``weights_only=False``: load only checkpoints you trust.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import torch

from lightningfastspeech2_tpu_torch.core.config import Config, ModelConfig
from lightningfastspeech2_tpu_torch.vocoder.hifigan import fold_weight_norm_state

# what the reference's on_save_checkpoint adds beside the state dict
# (fastspeech2.py:622-634)
SIDECAR_KEYS = ("stats", "phone2id", "speaker2id", "speaker2dvector", "speaker2priors",
                "speaker_gmms", "dvector_gmms")

State = Dict[str, torch.Tensor]


def fastspeech2_state_dict(state: Mapping[str, Any], cfg: ModelConfig) -> State:
    """A reference FastSpeech2 state dict (tensors or arrays, with or
    without a leading ``model.``) as the port's ``FastSpeech2`` state dict
    at ``cfg``: every key of that model, and no other (the residual head's
    ``fastdiff_linear`` where the state has it). Raises naming the keys
    the state lacks or whose shapes differ."""
    from lightningfastspeech2_tpu_torch.models.fastspeech2 import build_fastspeech2

    state = fold_weight_norm_state({k.removeprefix("model."): v for k, v in state.items()})
    want = build_fastspeech2(cfg, device="cpu",
                             use_fastdiff_head="fastdiff_linear.0.weight" in state).state_dict()
    missing = sorted(k for k in want if k not in state)
    if missing:
        raise KeyError(f"the reference state dict lacks {missing}")
    out = {k: torch.as_tensor(state[k]).to(v.dtype) for k, v in want.items()}
    wrong = sorted(k for k, v in want.items() if out[k].shape != v.shape)
    if wrong:
        raise ValueError(f"shapes differ from the model at {cfg}: "
                         f"{[(k, tuple(out[k].shape), tuple(want[k].shape)) for k in wrong]}")
    return out


def load_reference_checkpoint(path, cfg: Config | ModelConfig) -> Tuple[State, Dict[str, Any]]:
    """A reference ``.ckpt``: (the port's FastSpeech2 state dict at ``cfg``,
    the sidecar entries of ``SIDECAR_KEYS`` the checkpoint has). Serve it
    with ``build_fastspeech2(cfg.model, state_dict=...)``."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    model_cfg = cfg.model if isinstance(cfg, Config) else cfg
    sidecar = {k: ckpt[k] for k in SIDECAR_KEYS if k in ckpt}
    return fastspeech2_state_dict(ckpt["state_dict"], model_cfg), sidecar


def fastdiff_state_dict(state: Mapping[str, Any]) -> State:
    """A reference FastDiff state dict as the port's ``FastDiff`` one:
    bare, or a checkpoint nesting it at ``["state_dict"]["model"]`` (the
    reference train.py's layout), weight-norm pairs folded."""
    if "state_dict" in state:
        state = state["state_dict"]
    if isinstance(state.get("model"), Mapping):
        state = state["model"]
    return {k: torch.as_tensor(v) for k, v in fold_weight_norm_state(dict(state)).items()}
