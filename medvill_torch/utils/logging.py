"""``create_logger``: an elapsed-time formatter with console (and optional
file) handlers that dumps the run's arguments on creation (reference:
utils/logger.py:9-58; a copy of medvill_tpu/utils/logging.py's), and
``watch_norms``, the pretrain CLI's ``--watch_interval`` summary."""
from __future__ import annotations

import logging
import os
import sys
import time
from typing import Any, Dict, List, Optional

import torch

from medvill_torch import parallel


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
    if not parallel.is_main():
        # scale-out: rank 0 logs; the others report only what goes wrong
        logger.setLevel(logging.WARNING)
        filepath, args = None, None
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


def _norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """The global L2 norm of ``tensors`` in f32, on their device."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(
        [t.detach().float() for t in tensors])))


def watch_norms(model: torch.nn.Module, tx=None) -> Dict[str, float]:
    """The ``wandb.watch(model)`` stand-in of the JAX package
    (medvill_tpu/utils/logging.py:128-173; reference
    models/train_origin.py:51): ``watch/param_norm`` over every parameter
    (a tied table once, frozen ones included), ``watch/param_norm/<name>``
    per top-level module (``enc``, ``mlm``, ``itm`` in the pretrain layout)
    and, with ``tx`` (the run's ``train.optim.Accumulate``),
    ``watch/grad_ema_norm``, the norm of Adam's first moments (AdamW's
    ``exp_avg``, BertAdam's ``m``; 0 before the first update).  One read
    from the device; the CLI calls it off the hot path.  Under scale-out
    the norms are the whole model's (tensor-parallel slices and ZeRO-1
    chunks gathered), and every rank must call it."""
    params = {n: parallel.full_param(p, p.detach())
              for n, p in model.named_parameters()}
    norms = {"watch/param_norm": _norm(list(params.values()))}
    for top in sorted({name.split(".")[0] for name in params}):
        norms[f"watch/param_norm/{top}"] = _norm(
            [p for name, p in params.items()
             if name.split(".")[0] == top])
    if tx is not None:
        moments = [s[k] for s in tx.full_state()
                   for k in ("exp_avg", "m") if k in s]
        # zero before the first update, as JAX's zero-initialized moments
        norms["watch/grad_ema_norm"] = (
            _norm(moments) if moments else torch.zeros(
                (), device=norms["watch/param_norm"].device))
    values = torch.stack(list(norms.values())).tolist()
    return dict(zip(norms, values))
