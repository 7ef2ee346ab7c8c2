"""One rank of the two-process gloo world of tests/test_torch_parallel.py.

    python -m tests.torch_parallel_worker RANK WORLD DIR

joins the world through a ``file://`` store in DIR and runs every case the
test file holds against one process, each written to
``DIR/rank{RANK}_{case}.npz`` (or ``.json``):

- ``step_<case>``: the port's train step on this rank's half of the global
  batch in ``DIR/batch.npz`` (``DIR/batch_accum2.npz`` for ``accum2``),
  from the weights in ``DIR/params.pt``, under the config
  ``DIR/cfg_<case>.json``: the metrics, the updated parameters and the
  clipped global gradient;
- ``model_axis``: a ``(data 1, model 2)`` mesh, each rank stepping the
  whole batch;
- ``cli``: the train CLI's ``main`` with the arguments in
  ``DIR/cli_argv.json`` (a ZeRO-1 run), every file the rank wrote under
  the run's directory (an audit hook), each ``evaluate``'s metrics, then a
  third step of the run's state on the global batch of the first two
  scanned utterances.

It imports neither JAX nor the JAX package.
"""

import json
import os
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist


def _writes_under(root: str, log: list):
    """An audit hook that appends to ``log`` every path under ``root`` this
    process opens for writing, creates, renames to or removes."""
    flags = os.O_WRONLY | os.O_RDWR | os.O_CREAT

    def hook(event, args):
        if event == "open":
            path, mode, fl = args
            writes = (any(c in mode for c in "wax+") if isinstance(mode, str)
                      else bool(fl & flags))
        elif event == "os.rename":
            path, writes = args[1], True
        elif event in ("os.mkdir", "os.remove", "os.rmdir", "shutil.rmtree"):
            path, writes = args[0], True
        else:
            return
        if writes and isinstance(path, (str, bytes, os.PathLike)):
            path = os.fsdecode(path)
            if path.startswith(root):
                log.append(f"{event} {path}")

    return hook


def _step_case(work: Path, case: str, mesh) -> dict:
    from lightningfastspeech2_tpu_torch.core import config as C
    from lightningfastspeech2_tpu_torch.models.fastspeech2 import build_fastspeech2
    from lightningfastspeech2_tpu_torch.train.step import create_train_state, make_train_step

    cfg = C.load_json(str(work / f"cfg_{case}.json"))
    batch = dict(np.load(work / ("batch_accum2.npz" if case == "accum2" else "batch.npz")))
    if mesh.sharded:
        half = batch["phones"].shape[-2] // mesh.data
        share = slice(mesh.data_rank * half, (mesh.data_rank + 1) * half)
        batch = {k: (v[:, share] if case == "accum2" else v[share]) for k, v in batch.items()}
    model = build_fastspeech2(cfg.model, device="cpu",
                              state_dict=torch.load(work / "params.pt", weights_only=True))
    state = create_train_state(model, cfg, mesh)
    state, metrics = make_train_step(model, cfg, mesh)(state, batch,
                                                       torch.Generator().manual_seed(0))
    out = {f"metric::{k}": float(v) for k, v in metrics.items()}
    out["zero1"] = type(state.optimizer).__name__ == "ZeroRedundancyOptimizer"
    for name, value in model.state_dict().items():
        out[f"param::{name}"] = value.numpy().copy()
    for name, p in model.named_parameters():
        out[f"grad::{name}"] = p.grad.numpy().copy()
    return out


def _cli_case(rank, work: Path) -> dict:
    from lightningfastspeech2_tpu_torch.cli import train as cli
    from lightningfastspeech2_tpu_torch.core.bucketing import Bucketer
    from lightningfastspeech2_tpu_torch.data.dataset import TTSDataset
    from lightningfastspeech2_tpu_torch.parallel import mesh as mesh_lib
    from lightningfastspeech2_tpu_torch.train import loop
    from lightningfastspeech2_tpu_torch.train.step import make_train_step

    argv = json.loads((work / "cli_argv.json").read_text())
    evals = []
    evaluate = loop.evaluate

    def recorded(*args, **kwargs):
        metrics = evaluate(*args, **kwargs)
        evals.append({k: float(v) for k, v in metrics.items()})
        return metrics

    loop.evaluate = recorded
    writes: list = []
    sys.addaudithook(_writes_under(str(work / "cli"), writes))
    result = cli.main(argv)
    loop.evaluate = evaluate
    steps = result.state.step
    # the run's state takes a third step, on every rank, on the global batch
    # of the first two utterances (each rank its half)
    args = cli.build_parser().parse_args(argv)
    cfg = cli.args_to_config(args)
    ds = TTSDataset(Path(args.train_target_path), cli.data_config(args, cfg),
                    cache_dir=Path(args.cache_path), device="cpu")
    bucketer = Bucketer(cfg.model.max_phones, cfg.model.max_frames)
    batch = ds.collate([ds[0], ds[1]], bucketer)
    arrs = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
    mesh = mesh_lib.make_mesh()
    mine = {k: v[rank: rank + 1] for k, v in arrs.items()}
    state, metrics = make_train_step(result.state.model, cfg, mesh)(
        result.state, mine, torch.Generator().manual_seed(0))
    out = {"writes": writes, "evals": evals, "steps": steps,
           "third_step": {k: float(v) for k, v in metrics.items()},
           "optimizer": type(result.state.optimizer).__name__,
           "history": result.history}
    np.savez(work / f"rank{rank}_third_step.npz",
             **{f"batch::{k}": v for k, v in arrs.items()},
             **{f"param::{k}": v.numpy() for k, v in state.model.state_dict().items()})
    return out


def main(rank: int, world: int, work: Path) -> None:
    from lightningfastspeech2_tpu_torch.core.config import MeshConfig
    from lightningfastspeech2_tpu_torch.parallel import mesh as mesh_lib

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{work / 'store'}", rank=rank,
                            world_size=world)
    try:
        mesh = mesh_lib.make_mesh()
        for case in json.loads((work / "cases.json").read_text()):
            np.savez(work / f"rank{rank}_step_{case}.npz", **_step_case(work, case, mesh))
        # the model axis replicates: each rank of a (1, 2) mesh steps the
        # whole batch, with no collective
        axis = mesh_lib.make_mesh(MeshConfig(data=1, model=2))
        np.savez(work / f"rank{rank}_model_axis.npz",
                 model_rank=axis.model_rank, data_rank=axis.data_rank,
                 **_step_case(work, "plain", axis))
        (work / f"rank{rank}_cli.json").write_text(json.dumps(_cli_case(rank, work)))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
