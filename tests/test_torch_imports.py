"""The port stands alone: no module of ``lightningfastspeech2_tpu_torch`` (nor
``chip_smoke.py``) imports JAX, flax, optax, orbax or the JAX package, and
entry points refuse to run silently on the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "lightningfastspeech2_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "lightningfastspeech2_tpu")


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
    assert len(files) > 20
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
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'optax', 'orbax', 'lightningfastspeech2_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_default_device_raises_without_cuda():
    from lightningfastspeech2_tpu_torch.core.device import resolve_device
    from lightningfastspeech2_tpu_torch.vocoder.hifigan import Synthesiser

    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Synthesiser()
