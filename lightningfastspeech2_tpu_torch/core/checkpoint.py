"""Checkpoint directories: save and restore.

Counterpart of ``lightningfastspeech2_tpu/core/checkpoint.py`` with the same
directory layout, so the sidecars of either package read in the other:

    <dir>/latest                  the name of the newest step directory
    <dir>/step_XXXXXXXX/
        tree.pt                   torch.save({"params": ..., "step": int})
        config.json               core/config.py save_json
        sidecar.json              stats, phone2id, speaker2id, ... (JSON)
        sidecar.npz               dvec::<speaker>, prior::<speaker>::<prior>

The JAX package keeps its parameters in an orbax ``tree/`` directory, which
this package cannot read; ``scripts/jax_checkpoint_to_torch.py`` converts a
JAX checkpoint directory into this layout. ``params`` is a state dict, or a
dict of state dicts: ``{"acoustic": ..., "fastdiff": ...}`` for a joint
checkpoint, ``{"gen": ...}`` for a vocoder directory (its architecture in
the sidecar's ``hifigan_config``), as the JAX trees are nested.

Training's pieces (optimizer state, ``warm_start``, async writes and
multi-host barriers) are not ported yet.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from lightningfastspeech2_tpu_torch.core import config as C

TREE_FILE = "tree.pt"


def _to_tensors(tree: Any) -> Any:
    """Nested dicts of arrays -> nested dicts of CPU tensors."""
    if isinstance(tree, Mapping):
        return {k: _to_tensors(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return torch.as_tensor(np.asarray(tree))


class Checkpointer:
    def __init__(self, directory):
        self.dir = Path(directory).resolve()
        self.dir.mkdir(parents=True, exist_ok=True)

    def save(self, step: int, params: Mapping[str, Any],
             cfg: Optional[C.Config] = None,
             sidecar: Optional[Dict[str, Any]] = None) -> Path:
        """``params``: a state dict or a dict of them (arrays or tensors).
        ``sidecar`` may hold stats (dict), phone2id (dict), speaker2id
        (dict), speaker2dvector {name: array}, speaker2priors {name:
        {prior: array}} and any other JSON-safe entry."""
        path = self.dir / f"step_{step:08d}"
        if path.exists():
            shutil.rmtree(path)
        path.mkdir(parents=True)
        torch.save({"params": _to_tensors(params), "step": int(step)}, path / TREE_FILE)
        if cfg is not None:
            C.save_json(cfg, str(path / "config.json"))
        if sidecar:
            json_side: Dict[str, Any] = {}
            np_side: Dict[str, np.ndarray] = {}
            for key, value in sidecar.items():
                if key == "speaker2dvector":
                    for name, vec in value.items():
                        np_side[f"dvec::{name}"] = np.asarray(vec)
                elif key == "speaker2priors":
                    for name, priors in value.items():
                        for prior, arr in priors.items():
                            np_side[f"prior::{name}::{prior}"] = np.asarray(arr)
                else:
                    json_side[key] = value
            (path / "sidecar.json").write_text(json.dumps(json_side))
            if np_side:
                np.savez(path / "sidecar.npz", **np_side)
        (self.dir / "latest").write_text(path.name)
        return path

    def latest_path(self) -> Optional[Path]:
        marker = self.dir / "latest"
        if not marker.exists():
            return None
        path = self.dir / marker.read_text().strip()
        return path if path.exists() else None

    def restore(self, path: Optional[Path] = None
                ) -> Tuple[Dict[str, Any], Optional[C.Config], Dict[str, Any]]:
        """Returns (tree, cfg, sidecar): tree is ``{"params": ..., "step":
        int}`` with CPU tensors, cfg None without a config.json."""
        path = Path(path) if path else self.latest_path()
        if path is None:
            raise FileNotFoundError(f"no checkpoint under {self.dir}")
        if not (path / TREE_FILE).exists():
            raise FileNotFoundError(
                f"{path} holds no {TREE_FILE}; a JAX checkpoint directory is "
                "converted by scripts/jax_checkpoint_to_torch.py")
        tree = torch.load(path / TREE_FILE, weights_only=True, map_location="cpu")
        return tree, read_config(path), read_sidecar(path)


def read_config(path) -> Optional[C.Config]:
    """A step directory's config.json (either package's), or None."""
    path = Path(path)
    return C.load_json(str(path / "config.json")) if (path / "config.json").exists() else None


def read_sidecar(path) -> Dict[str, Any]:
    """A step directory's sidecar.json and sidecar.npz (either package's),
    with the d-vector and prior tables back under ``speaker2dvector`` and
    ``speaker2priors``."""
    path = Path(path)
    sidecar: Dict[str, Any] = {}
    if (path / "sidecar.json").exists():
        sidecar = json.loads((path / "sidecar.json").read_text())
    if (path / "sidecar.npz").exists():
        data = np.load(path / "sidecar.npz", allow_pickle=False)
        dvec: Dict[str, np.ndarray] = {}
        priors: Dict[str, Dict[str, np.ndarray]] = {}
        for key in data.files:
            if key.startswith("dvec::"):
                dvec[key[6:]] = data[key]
            elif key.startswith("prior::"):
                _, name, prior = key.split("::")
                priors.setdefault(name, {})[prior] = data[key]
        if dvec:
            sidecar["speaker2dvector"] = dvec
        if priors:
            sidecar["speaker2priors"] = priors
    return sidecar
