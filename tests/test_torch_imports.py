"""The port stands alone: no module of ``lightningfastspeech2_tpu_torch`` (nor
``chip_smoke.py``) imports JAX, flax, optax, orbax, msgpack, scikit-learn,
huggingface_hub, the JAX package or the repo's ``scripts/``, and entry
points refuse to run silently on the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "lightningfastspeech2_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "msgpack", "sklearn",
             "huggingface_hub", "lightningfastspeech2_tpu", "scripts")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_no_forbidden_imports():
    files = _port_files()
    assert len(files) > 20 and PORT / "parallel" / "mesh.py" in files
    assert {PORT / "cli" / "plot.py", PORT / "utils" / "debug.py",
            PORT / "utils" / "reference_checkpoint.py"} <= set(files)
    bad = []
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            if top in FORBIDDEN:
                bad.append(f"{path.relative_to(ROOT)}: {mod}")
    assert not bad, bad


def test_import_leaves_jax_out():
    code = (
        "import sys\n"
        "import lightningfastspeech2_tpu_torch\n"
        "from lightningfastspeech2_tpu_torch.synthesis import generator\n"
        "from lightningfastspeech2_tpu_torch.models import fastspeech2\n"
        "from lightningfastspeech2_tpu_torch.vocoder import hifigan\n"
        "from lightningfastspeech2_tpu_torch.utils import convert\n"
        "from lightningfastspeech2_tpu_torch.train import losses, optim, step\n"
        "from lightningfastspeech2_tpu_torch.ops import attention, dropout, ffn\n"
        "from lightningfastspeech2_tpu_torch.ops import length_regulator, soft_dtw\n"
        "from lightningfastspeech2_tpu_torch.ops import fastdiff_lvc\n"
        "from lightningfastspeech2_tpu_torch.vocoder import diffusion, fastdiff\n"
        "from lightningfastspeech2_tpu_torch.models import joint\n"
        "from lightningfastspeech2_tpu_torch.cli import generate\n"
        "from lightningfastspeech2_tpu_torch.core import checkpoint\n"
        "from lightningfastspeech2_tpu_torch.utils import log_gmm, flax_msgpack\n"
        "from lightningfastspeech2_tpu_torch.synthesis import (\n"
        "    augment, denoiser, g2p, neural_g2p, restore)\n"
        "from lightningfastspeech2_tpu_torch.data import wav\n"
        "from lightningfastspeech2_tpu_torch.audio import cwt, features, mel, pitch, snr\n"
        "from lightningfastspeech2_tpu_torch.data import (\n"
        "    alignment, dataset, dvector, loader, synthetic, textgrid)\n"
        "from lightningfastspeech2_tpu_torch.train import loop, metrics, metrics_logger, swa\n"
        "from lightningfastspeech2_tpu_torch.cli import train\n"
        "from lightningfastspeech2_tpu_torch.utils import plotting\n"
        "from lightningfastspeech2_tpu_torch import native\n"
        "from lightningfastspeech2_tpu_torch.ops import splines\n"
        "from lightningfastspeech2_tpu_torch.models import draws, fastdiff_variances, sdp\n"
        "from lightningfastspeech2_tpu_torch.audio import srmr\n"
        "from lightningfastspeech2_tpu_torch.vocoder import hifigan_train\n"
        "from lightningfastspeech2_tpu_torch.cli import train_vocoder\n"
        "from lightningfastspeech2_tpu_torch.train import on_device_features\n"
        "from lightningfastspeech2_tpu_torch.cli import train_denoiser, train_g2p\n"
        "import lightningfastspeech2_tpu_torch.parallel\n"
        "from lightningfastspeech2_tpu_torch.parallel import mesh\n"
        "from lightningfastspeech2_tpu_torch.cli import plot\n"
        "from lightningfastspeech2_tpu_torch.utils import debug, reference_checkpoint\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_default_device_raises_without_cuda():
    from lightningfastspeech2_tpu_torch.core.device import resolve_device
    from lightningfastspeech2_tpu_torch.vocoder.fastdiff import FastDiffVocoder
    from lightningfastspeech2_tpu_torch.vocoder.hifigan import Synthesiser

    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Synthesiser()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FastDiffVocoder()
    from lightningfastspeech2_tpu_torch.audio.srmr import srmr_per_window
    from lightningfastspeech2_tpu_torch.core import config as C
    from lightningfastspeech2_tpu_torch.models.joint import (
        JointFastSpeech2FastDiff,
        make_fastdiff_config,
    )

    with pytest.raises(RuntimeError, match="no CUDA device"):
        srmr_per_window([0.0] * 8000)
    m = C.canonical_joint().model
    with pytest.raises(RuntimeError, match="no CUDA device"):
        JointFastSpeech2FastDiff(m, make_fastdiff_config(m))
    from lightningfastspeech2_tpu_torch.cli import train_vocoder
    from lightningfastspeech2_tpu_torch.vocoder.hifigan_train import Discriminators, HifiGanTrainer

    with pytest.raises(RuntimeError, match="no CUDA device"):
        Discriminators()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HifiGanTrainer()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_vocoder.main(["--train_target_path", "."])
    from lightningfastspeech2_tpu_torch.cli import train_denoiser, train_g2p
    from lightningfastspeech2_tpu_torch.synthesis.denoiser import train_denoiser as train_dn
    from lightningfastspeech2_tpu_torch.synthesis.neural_g2p import train_neural_g2p

    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_neural_g2p({"cat": ["K", "AE1", "T"]}, steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_dn([np.zeros(8192, np.float32)], steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_g2p.main(["--lexicon", "missing.txt"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_denoiser.main(["--corpus", "missing", "--out", "unused.npz"])
