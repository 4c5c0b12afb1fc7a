"""Seeding (reference: utils/utils.py:9-16)."""
from __future__ import annotations

import random

import numpy as np
import torch


def set_seed(seed: int) -> None:
    """Seed python, numpy and torch (every device's default generator)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
