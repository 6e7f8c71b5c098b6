"""Metrics logging (copy of train/logger.py).

The reference logs Total/L1/HFEN/Temporal scalars to TensorBoard through a
TF1 FileWriter (tensorboard.py:11-72).  Here metrics stream to a JSONL file
(always) and to TensorBoard when the library is importable.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricsLogger:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._fh = open(self.path, "a")
        self._tb = None
        try:  # optional TensorBoard writer
            from torch.utils.tensorboard import SummaryWriter
            self._tb = SummaryWriter(log_dir)
        except ImportError:
            self._tb = None

    def scalars(self, step: int, values: Dict[str, float]):
        rec = {"step": step, "time": time.time(), **values}
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        if self._tb is not None:
            for tag, v in values.items():
                self._tb.add_scalar(tag, v, step)

    def close(self):
        self._fh.close()
        if self._tb is not None:
            self._tb.close()
