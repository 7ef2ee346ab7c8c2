#!/usr/bin/env python
"""Convert a checkpoint directory of the JAX package into one of the
PyTorch port, so the port's generate CLI serves it.

    python scripts/jax_checkpoint_to_torch.py SRC DST [--step N]

SRC is an acoustic checkpoint directory (``cli/train.py``; a joint
``{"acoustic", "fastdiff"}`` tree too) or a vocoder directory
(``cli/train_vocoder.py``, ``hifigan_config`` in its sidecar). The params
are restored with the JAX ``Checkpointer`` and mapped by the port's
``utils/convert.py`` (``from_jax_fastspeech2``, ``from_jax_fastdiff``,
``from_jax_hifigan``, ``from_jax_discriminators``); DST gets the port's
``tree.pt`` with the same ``config.json`` and sidecars, and
``prior_gmms.pkl`` / ``dvector_gmms.pkl`` are copied beside it (the port
reads them without scikit-learn).

A vocoder directory converts whole: the generator, the discriminators, both
optimizer states (``adamw_state_from_optax``) and the step, so that the
port's ``cli.train_vocoder --from_checkpoint DST`` resumes the JAX run
where it stopped, with its learning-rate schedule.

This is the one program that imports both packages; it runs where JAX and
orbax are installed, on the CPU.
"""

import argparse
import os
import shutil
import sys
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np


def vocoder_state(params, opt_state, hcfg):
    """A JAX vocoder run's ``{"gen", "disc"}`` params and optax states as
    the port trainer's (``HifiGanTrainer.params()`` / ``opt_state()``):
    each optimizer's moments in the order of the port module's
    parameters."""
    from lightningfastspeech2_tpu_torch.utils.convert import (
        adamw_state_from_optax,
        from_jax_discriminators,
        from_jax_hifigan,
    )
    from lightningfastspeech2_tpu_torch.vocoder.hifigan import Generator
    from lightningfastspeech2_tpu_torch.vocoder.hifigan_train import Discriminators

    to_state = {"gen": lambda p: from_jax_hifigan(p, hcfg), "disc": from_jax_discriminators}
    # the port modules give the parameters' names in each optimizer's order
    modules = {"gen": Generator(hcfg), "disc": Discriminators(device="cpu")}
    out = {k: to_state[k](params[k]) for k in ("gen", "disc")}
    if opt_state is None:
        return out, None
    return out, {k: adamw_state_from_optax(opt_state[k], params[k], to_state[k],
                                           [n for n, _ in modules[k].named_parameters()])
                 for k in ("gen", "disc")}


def convert(src, dst, step=None) -> Path:
    """SRC -> DST; returns the written step directory."""
    from lightningfastspeech2_tpu.core.checkpoint import Checkpointer as JaxCheckpointer
    from lightningfastspeech2_tpu_torch.core import config as TC
    from lightningfastspeech2_tpu_torch.core.checkpoint import Checkpointer, read_config
    from lightningfastspeech2_tpu_torch.models.joint import make_fastdiff_config
    from lightningfastspeech2_tpu_torch.utils.convert import (
        from_jax_fastdiff,
        from_jax_fastspeech2,
        from_jax_hifigan,
    )
    from lightningfastspeech2_tpu_torch.vocoder.hifigan import HifiGanConfig

    src, dst = Path(src), Path(dst)
    path = src / f"step_{int(step):08d}" if step is not None else None
    tree, _, sidecar = JaxCheckpointer(src).restore(path)
    path = path or JaxCheckpointer(src).latest_path()
    params = jax.tree_util.tree_map(np.asarray, tree["params"])
    step_n = int(np.asarray(tree.get("step", 0)))
    cfg = read_config(path)

    opt_state = None
    if "gen" in params:  # a vocoder directory
        gc = sidecar.get("hifigan_config")
        hcfg = HifiGanConfig.from_dict(gc) if gc else HifiGanConfig()
        out = {"gen": from_jax_hifigan(params["gen"], hcfg)}
        if "disc" in params:
            out, opt_state = vocoder_state(params, tree.get("opt_state"), hcfg)
    else:
        if cfg is None:
            raise ValueError(f"{path} has no config.json")
        phone2id = sidecar.get("phone2id", {"[PAD]": 0})
        mcfg = TC.replace(cfg.model, vocab_size=max(len(phone2id), 2))
        if "acoustic" in params:  # joint: {"acoustic": ..., "fastdiff": ...}
            out = {"acoustic": from_jax_fastspeech2(params["acoustic"], mcfg),
                   "fastdiff": from_jax_fastdiff(params["fastdiff"],
                                                 make_fastdiff_config(mcfg))}
        else:
            out = from_jax_fastspeech2(params, mcfg)
    written = Checkpointer(dst).save(step_n, out, cfg, sidecar, opt_state=opt_state)
    for name in ("prior_gmms.pkl", "dvector_gmms.pkl"):
        if (src / name).exists():
            shutil.copyfile(src / name, dst / name)
    return written


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("src", help="JAX checkpoint directory")
    p.add_argument("dst", help="port checkpoint directory to write")
    p.add_argument("--step", type=int, default=None, help="step to convert (default: latest)")
    args = p.parse_args(argv)
    print(f"wrote {convert(args.src, args.dst, args.step)}")


if __name__ == "__main__":
    main()
