"""Experiment logging: console + JSONL file + optional wandb.

Copy of ``omr_a2s_multimodal_transformer_tpu/utils/logging.py``. Keeps the
reference's metric names (train_loss, {val,test}_sym-er, {val,test}_seq-er;
wandb project "OMR-A2S-Poly-Multimodal") while always writing a local JSONL
so runs are inspectable without external services. wandb is imported only
when asked for.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict, Optional


class MetricsLogger:
    def __init__(
        self,
        run_dir: str,
        use_wandb: bool = False,
        wandb_project: str = "OMR-A2S-Poly-Multimodal",
        wandb_group: Optional[str] = None,
        wandb_name: Optional[str] = None,
        config: Optional[Dict] = None,
    ):
        os.makedirs(run_dir, exist_ok=True)
        self.path = os.path.join(run_dir, "metrics.jsonl")
        self._fh = open(self.path, "a")
        self._t0 = time.time()
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb.init(
                    project=wandb_project, group=wandb_group, name=wandb_name, config=config or {}
                )
            except Exception as e:  # no wandb installed / no API key
                print(f"[logging] wandb disabled ({e})", file=sys.stderr)
        if config:
            self.log({"config": config}, step=-1, quiet=True)

    def log(self, metrics: Dict, step: int, quiet: bool = False) -> None:
        rec = {"step": step, "time": round(time.time() - self._t0, 3), **metrics}
        self._fh.write(json.dumps(rec, default=float) + "\n")
        self._fh.flush()
        if self._wandb is not None and step >= 0:
            self._wandb.log(metrics, step=step)
        if not quiet:
            parts = " ".join(
                f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}" for k, v in metrics.items()
            )
            print(f"[step {step}] {parts}", flush=True)

    def close(self) -> None:
        self._fh.close()
        if self._wandb is not None:
            self._wandb.finish()


class NullLogger:
    """The logger of a rank other than 0 in a multi-process run: records nothing."""

    def __init__(self, run_dir: str):
        self.path = os.path.join(run_dir, "metrics.jsonl")

    def log(self, metrics: Dict, step: int, quiet: bool = False) -> None:
        pass

    def close(self) -> None:
        pass
