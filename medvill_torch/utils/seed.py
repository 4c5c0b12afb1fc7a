"""Seeding (reference: utils/utils.py:9-16) and the scoped numpy seed."""
from __future__ import annotations

import contextlib
import random

import numpy as np
import torch


def set_seed(seed: int) -> None:
    """Seed python, numpy and torch (every device's default generator)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


@contextlib.contextmanager
def numpy_seed(seed, *addl_seeds):
    """Scoped numpy global seed, the state restored on exit (reference:
    utils/utils.py:52-66; a copy of medvill_tpu/utils/seed.py's)."""
    if seed is None:
        yield
        return
    if len(addl_seeds) > 0:
        seed = int(hash((seed, *addl_seeds)) % 1e6)
    state = np.random.get_state()
    np.random.seed(seed)
    try:
        yield
    finally:
        np.random.set_state(state)
