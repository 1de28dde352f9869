"""Singleton run logger + scalar-metrics writers (the counterpart of
mtamrecommender_tpu/utils/logging.py).

Port of the reference's `util/model_log.py` (console + timestamped file
under data/log_data/) plus a structured replacement for its TensorBoard
scalars: a JSONL event stream that any dashboard can tail, and an
optional torch SummaryWriter when tensorboard is wanted (the reference's
`base_model.summery()` twin FileWriters, Model/base_model.py:274-288).
The logger is named ``"mtamrec_torch"``, apart from the JAX package's
``"mtamrec"``, so a process that imports both shares no handlers.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Dict, Optional

_LOCK = threading.Lock()
_LOGGER: Optional[logging.Logger] = None


def create_log(type: str = "", experiment_type: str = "", version: str = "",
               log_dir: str = "data/log_data") -> logging.Logger:
    """Thread-safe singleton logger (model_log.py:5-49)."""
    global _LOGGER
    if _LOGGER is not None:
        return _LOGGER
    with _LOCK:
        if _LOGGER is not None:
            return _LOGGER
        logger = logging.getLogger("mtamrec_torch")
        logger.setLevel(logging.INFO)
        logger.propagate = False
        fmt = logging.Formatter(
            "%(asctime)s - %(levelname)s - %(message)s")
        stream = logging.StreamHandler()
        stream.setFormatter(fmt)
        logger.addHandler(stream)
        try:
            os.makedirs(log_dir, exist_ok=True)
            ts = time.strftime("%Y-%m-%d--%H-%M-%S")
            name = "_".join(x for x in (type, experiment_type, version, ts)
                            if x) or ts
            fh = logging.FileHandler(os.path.join(log_dir, f"{name}_log.txt"))
            fh.setFormatter(fmt)
            logger.addHandler(fh)
        except OSError:
            pass  # read-only fs: console-only logging
        _LOGGER = logger
        return logger


def reset_log() -> None:
    global _LOGGER
    with _LOCK:
        if _LOGGER is not None:
            for h in list(_LOGGER.handlers):
                _LOGGER.removeHandler(h)
        _LOGGER = None


class MetricsWriter:
    """Scalar event stream: JSONL always; TensorBoard if available."""

    def __init__(self, run_dir: str, use_tensorboard: bool = False):
        os.makedirs(run_dir, exist_ok=True)
        self._jsonl = open(os.path.join(run_dir, "events.jsonl"), "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(run_dir)
            except Exception:
                self._tb = None

    def scalars(self, step: int, values: Dict[str, float]) -> None:
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in values.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in values.items():
                self._tb.add_scalar(k, float(v), int(step))

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


def quiet_log() -> logging.Logger:
    """A logger that drops every record: the non-chief ranks' of a
    sharded run, where only rank 0 logs."""
    logger = logging.getLogger("mtamrec_torch.quiet")
    logger.propagate = False
    logger.disabled = True
    return logger


class NullWriter:
    """A `MetricsWriter` that writes nothing (the non-chief ranks')."""

    def scalars(self, step: int, values: Dict[str, float]) -> None:
        del step, values

    def close(self) -> None:
        pass
