"""Rank-0-only logging (counterpart of `pmf_tpu/utils/logger.py`).

Process 0 of the process group is the main process; with no group up the
one process is.
"""
from __future__ import annotations

import logging
import os
import sys

import torch.distributed as dist

FORMAT = logging.Formatter("%(asctime)s %(levelname)s: %(message)s", "%Y-%m-%d %H:%M:%S")


def is_main_process() -> bool:
    """True on rank 0 of the process group, and when no group is up."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def make_logger(name: str = "pmf_tpu_torch", log_file: str | None = None,
                main_only: bool = True) -> logging.Logger:
    """The logger `name` at INFO, writing to stdout and to `log_file`; off
    the main process (with main_only) a silent one. Its earlier handlers are
    closed and replaced, and it does not pass records to its parents."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    logger.propagate = False
    if main_only and not is_main_process():
        logger.addHandler(logging.NullHandler())
        return logger
    console = logging.StreamHandler(sys.stdout)
    console.setFormatter(FORMAT)
    logger.addHandler(console)
    if log_file is not None:
        os.makedirs(os.path.dirname(os.path.abspath(log_file)), exist_ok=True)
        handler = logging.FileHandler(log_file)
        handler.setFormatter(FORMAT)
        logger.addHandler(handler)
    return logger
