"""Checkpoint directories: save, restore, warm start.

Counterpart of ``lightningfastspeech2_tpu/core/checkpoint.py`` with the same
directory layout, so the sidecars of either package read in the other:

    <dir>/latest                  the name of the newest step directory
    <dir>/step_XXXXXXXX/
        tree.pt                   torch.save({"params": ..., "step": int,
                                              "opt_state": ...})
        config.json               core/config.py save_json
        sidecar.json              stats, phone2id, speaker2id, ... (JSON)
        sidecar.npz               dvec::<speaker>, prior::<speaker>::<prior>

The JAX package keeps its parameters in an orbax ``tree/`` directory, which
this package cannot read; ``scripts/jax_checkpoint_to_torch.py`` converts a
JAX checkpoint directory into this layout. ``params`` is a state dict, or a
dict of state dicts: ``{"acoustic": ..., "fastdiff": ...}`` for a joint
checkpoint, ``{"gen": ...}`` for a vocoder directory (its architecture in
the sidecar's ``hifigan_config``), as the JAX trees are nested.
``opt_state``, written by the trainer, is the optimizer's ``state_dict()``.

``use_async=True`` writes ``tree.pt`` on a background thread: ``save()``
blocks only while the tensors are copied to the host (the train step then
updates the live ones in place), the ``latest`` marker is published in
``wait_until_finished()`` after the write finished, and ``restore`` /
``latest_path`` wait implicitly, so a crash mid-write never leaves
``latest`` pointing at a torn checkpoint.

Under several ranks (parallel/mesh.py) every rank calls ``save`` and
``wait_until_finished`` in the same order, and rank 0 alone touches the
disk, in the JAX package's order: it removes a stale step directory, a
barrier follows, it writes the tree, the config and the sidecars; a barrier
ends a synchronous save, and one follows the publication of ``latest`` for
an asynchronous one, so that no rank reads ``latest`` before it names a
whole checkpoint. Every rank restores. A ZeRO-1 optimizer's shares are
gathered before ``save`` (train/step.py ``optimizer_state_dict``, a
collective), so the file holds a plain AdamW ``state_dict()`` whatever the
number of ranks.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from lightningfastspeech2_tpu_torch.core import config as C
from lightningfastspeech2_tpu_torch.parallel import mesh as mesh_lib

TREE_FILE = "tree.pt"


def _to_tensors(tree: Any) -> Any:
    """Nested dicts of arrays -> nested dicts of CPU tensors, copies of
    tensors that are already on the CPU."""
    if isinstance(tree, Mapping):
        return {k: _to_tensors(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return torch.as_tensor(np.asarray(tree))


def _host_copy(tree: Any) -> Any:
    """An optimizer ``state_dict()`` with every tensor copied to the CPU
    (the structure and other values as they are)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, Mapping):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_copy(v) for v in tree)
    return tree


class Checkpointer:
    def __init__(self, directory, use_async: bool = False):
        self.dir = Path(directory).resolve()
        if mesh_lib.is_main():
            self.dir.mkdir(parents=True, exist_ok=True)
        self._async = bool(use_async)
        self._writer: Optional[threading.Thread] = None
        self._pending: Optional[str] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, params: Mapping[str, Any],
             cfg: Optional[C.Config] = None,
             sidecar: Optional[Dict[str, Any]] = None,
             opt_state: Optional[Mapping[str, Any]] = None) -> Path:
        """``params``: a state dict or a dict of them (arrays or tensors).
        ``sidecar`` may hold stats (dict), phone2id (dict), speaker2id
        (dict), speaker2dvector {name: array}, speaker2priors {name:
        {prior: array}} and any other JSON-safe entry. ``opt_state``: an
        optimizer's ``state_dict()``. Tensors are copied to the host before
        this returns, also when the write goes on in the background."""
        # one write in flight: finish (and publish) the previous one first
        self.wait_until_finished()
        path = self.dir / f"step_{step:08d}"
        multi = mesh_lib.world_size() > 1
        main = mesh_lib.is_main()
        if main and path.exists():
            shutil.rmtree(path)
        if multi:
            mesh_lib.barrier(f"ckpt_pre_save_{step}")
        if not main:
            if self._async:
                self._pending = path.name
            elif multi:
                mesh_lib.barrier(f"ckpt_post_save_{step}")
            return path
        path.mkdir(parents=True)
        tree = {"params": _to_tensors(params), "step": int(step)}
        if opt_state is not None:
            tree["opt_state"] = _host_copy(opt_state)
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
        if self._async:
            self._pending = path.name
            self._writer = threading.Thread(target=self._write, args=(tree, path),
                                            name=f"checkpoint-{path.name}", daemon=False)
            self._writer.start()
        else:
            _write_tree(tree, path)
            (self.dir / "latest").write_text(path.name)
            if multi:
                # the other ranks may read ``latest`` right after save()
                mesh_lib.barrier(f"ckpt_post_save_{step}")
        return path

    def _write(self, tree: Dict[str, Any], path: Path) -> None:
        try:
            _write_tree(tree, path)
        except Exception as e:  # re-raised by wait_until_finished
            self._error = e

    def wait_until_finished(self) -> None:
        """Block until the write in flight finished, then publish its
        ``latest`` marker (rank 0) and wait for every rank; re-raises the
        write's error. A no-op when no write is in flight."""
        if self._pending is None:
            return
        pending, self._pending = self._pending, None
        if self._writer is not None:
            self._writer.join()
            self._writer = None
            if self._error is not None:
                error, self._error = self._error, None
                raise RuntimeError(f"checkpoint {pending} was not written") from error
            (self.dir / "latest").write_text(pending)
        if mesh_lib.world_size() > 1:
            mesh_lib.barrier(f"ckpt_publish_{pending}")

    def latest_path(self) -> Optional[Path]:
        self.wait_until_finished()
        marker = self.dir / "latest"
        if not marker.exists():
            return None
        path = self.dir / marker.read_text().strip()
        return path if path.exists() else None

    def restore(self, path: Optional[Path] = None
                ) -> Tuple[Dict[str, Any], Optional[C.Config], Dict[str, Any]]:
        """Returns (tree, cfg, sidecar): tree is ``{"params": ..., "step":
        int}`` (and ``"opt_state"`` where the trainer wrote one) with CPU
        tensors, cfg None without a config.json."""
        self.wait_until_finished()
        path = Path(path) if path else self.latest_path()
        if path is None:
            raise FileNotFoundError(f"no checkpoint under {self.dir}")
        if not (path / TREE_FILE).exists():
            raise FileNotFoundError(
                f"{path} holds no {TREE_FILE}; a JAX checkpoint directory is "
                "converted by scripts/jax_checkpoint_to_torch.py")
        tree = torch.load(path / TREE_FILE, weights_only=True, map_location="cpu")
        return tree, read_config(path), read_sidecar(path)


def _write_tree(tree: Dict[str, Any], path: Path) -> None:
    tmp = path / (TREE_FILE + ".tmp")
    torch.save(tree, tmp)
    os.replace(tmp, path / TREE_FILE)


def warm_start(fresh: Mapping[str, torch.Tensor], restored: Mapping[str, Any]
               ) -> Tuple[Dict[str, torch.Tensor], int, int]:
    """Merge a restored state dict into a freshly initialized one by name and
    shape (the reference's tolerant ``strict=False`` resume,
    ``fastspeech2.py:599-620``): a fresh tensor whose name is restored with
    the same shape takes the restored values (in the fresh dtype), any
    other keeps its fresh values; restored names the model lacks are left
    out. Returns (merged, used, dropped), the counts of fresh tensors taken
    from ``restored`` and kept fresh."""
    merged: Dict[str, torch.Tensor] = {}
    used = dropped = 0
    for name, leaf in fresh.items():
        old = restored.get(name)
        if old is not None and tuple(old.shape) == tuple(leaf.shape):
            merged[name] = torch.as_tensor(old).to(leaf.dtype)
            used += 1
        else:
            merged[name] = leaf
            dropped += 1
    return merged, used, dropped


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
