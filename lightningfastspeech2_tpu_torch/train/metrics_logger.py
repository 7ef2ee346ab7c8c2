"""Console and JSONL metrics sink.

Counterpart of ``lightningfastspeech2_tpu/train/metrics_logger.py``: one
``step N: k=v ...`` line per call on stdout and one JSON object per call in
``<log_dir>/metrics.jsonl``, with the reference's ``train/*_loss`` /
``eval/*`` names. ``use_wandb`` attaches wandb where it is installed, and
otherwise says so on stderr and goes on. Under several ranks only rank 0
logs, to the console, the JSONL file and wandb (parallel/mesh.py); the
others' ``log`` does nothing, since every rank's metrics are the global
batch's.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path
from typing import Dict, Optional

from lightningfastspeech2_tpu_torch.parallel import mesh as mesh_lib


class MetricsLogger:
    def __init__(self, log_dir: Optional[str] = None, use_wandb: bool = False,
                 wandb_project: Optional[str] = None, quiet: bool = False):
        self.is_main = mesh_lib.is_main()
        self.quiet = quiet
        self.jsonl = None
        if log_dir and self.is_main:
            path = Path(log_dir)
            path.mkdir(parents=True, exist_ok=True)
            self.jsonl = open(path / "metrics.jsonl", "a")
        self.wandb = None
        if use_wandb and self.is_main:
            try:
                import wandb

                wandb.init(project=wandb_project or "lightningfastspeech2_tpu")
                self.wandb = wandb
            except Exception:
                print("wandb unavailable; falling back to console/JSONL", file=sys.stderr)

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        if not self.is_main:
            return
        if not self.quiet:
            parts = " ".join(f"{k}={v:.4g}" for k, v in sorted(metrics.items())
                             if isinstance(v, (int, float)))
            print(f"step {step}: {parts}", flush=True)
        if self.jsonl:
            self.jsonl.write(json.dumps({"step": step, "ts": time.time(), **metrics}) + "\n")
            self.jsonl.flush()
        if self.wandb:
            self.wandb.log(metrics, step=step)

    def close(self) -> None:
        if self.jsonl:
            self.jsonl.close()
            self.jsonl = None
        if self.wandb:
            self.wandb.finish()
