"""Logger factory (reference utils.py:544-587) and timing decorator
(reference utils.py:590-616)."""

from __future__ import annotations

import functools
import logging
import os
import time
from typing import Optional


def get_logger(name: str, save_dir: Optional[str] = None,
               quiet: bool = False) -> logging.Logger:
    """Named logger with console + verbose.log/quiet.log file handlers."""
    logger = logging.getLogger(name)
    # Rebuild handlers every call: a cached logger would keep file handlers
    # pointing at a previous run's save_dir (breaks repeated in-process runs).
    for handler in list(logger.handlers):
        handler.close()
        logger.removeHandler(handler)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False

    ch = logging.StreamHandler()
    ch.setLevel(logging.INFO if quiet else logging.DEBUG)
    logger.addHandler(ch)

    if save_dir is not None:
        os.makedirs(save_dir, exist_ok=True)
        fh_v = logging.FileHandler(os.path.join(save_dir, "verbose.log"))
        fh_v.setLevel(logging.DEBUG)
        fh_q = logging.FileHandler(os.path.join(save_dir, "quiet.log"))
        fh_q.setLevel(logging.INFO)
        logger.addHandler(fh_v)
        logger.addHandler(fh_q)
    return logger


def timeit(logger_name: Optional[str] = None):
    """Wall-clock timing decorator (reference utils.py:590-616)."""
    def decorator(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            start = time.time()
            result = fn(*args, **kwargs)
            delta = time.time() - start
            msg = f"Elapsed time = {delta:.2f} s"
            (logging.getLogger(logger_name).info if logger_name else print)(msg)
            return result
        return wrapper
    return decorator
