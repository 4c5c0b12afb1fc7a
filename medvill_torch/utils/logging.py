"""``create_logger``: an elapsed-time formatter with console (and optional
file) handlers that dumps the run's arguments on creation (reference:
utils/logger.py:9-58; a copy of medvill_tpu/utils/logging.py's)."""
from __future__ import annotations

import logging
import os
import sys
import time
from typing import Any, Optional


class ElapsedFormatter(logging.Formatter):
    """Prefix records with the wall clock and the time since creation."""

    def __init__(self):
        super().__init__()
        self.start = time.time()

    def format(self, record):
        elapsed = int(record.created - self.start)
        prefix = "%s - %02d:%02d:%02d" % (
            time.strftime("%x %X"), elapsed // 3600,
            (elapsed % 3600) // 60, elapsed % 60)
        return f"{prefix} - {record.getMessage()}"


def create_logger(filepath: Optional[str] = None,
                  args: Optional[Any] = None) -> logging.Logger:
    logger = logging.getLogger("medvill_torch")
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    fmt = ElapsedFormatter()
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if filepath:
        os.makedirs(os.path.dirname(filepath) or ".", exist_ok=True)
        fh = logging.FileHandler(filepath)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    if args is not None:
        d = args.__dict__ if hasattr(args, "__dict__") else dict(args)
        for k in sorted(d):
            logger.info("%s: %s", k, d[k])
    return logger
