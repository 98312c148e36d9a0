"""Console and metrics logging (counterpart of dss_tpu/utils/logging.py).

Metrics go to `<out_dir>/metrics.jsonl` always, and to TensorBoard where
`torch.utils.tensorboard` imports.
"""
from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Dict, Optional

_FMT = "%(asctime)s %(name)s %(levelname)s: %(message)s"


def get_logger(name: str = "dss_tpu_torch",
               logfile: Optional[str] = None) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stdout)
        h.setFormatter(logging.Formatter(_FMT))
        logger.addHandler(h)
        logger.setLevel(logging.INFO)
    if logfile:
        fh = logging.FileHandler(logfile)
        fh.setFormatter(logging.Formatter(_FMT))
        logger.addHandler(fh)
    return logger


class MetricsLogger:
    """Scalar metrics → <out_dir>/metrics.jsonl + optional TensorBoard."""

    def __init__(self, out_dir: str, tensorboard: bool = True):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, "metrics.jsonl")
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:  # the tensorboard package is not installed
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(os.path.join(out_dir, "tb"))

    def log(self, step: int, scalars: Dict[str, float]) -> None:
        rec = {"step": int(step), "time": time.time(), **scalars}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, v, step)

    def close(self):
        if self._tb is not None:
            self._tb.close()
