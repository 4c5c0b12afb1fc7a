"""BertAdam's update on the card: ``csrc/bert_adam.cu``'s two launches.

``train/optim.py``'s ``BertAdam`` calls ``bert_adam`` for CUDA parameters;
its foreach chain stays the plain version, which the CPU takes.  The
kernels replace no TPU kernel (the JAX package leaves the update to XLA);
they compute the chain's update, in its f32 and its order of operations,
in one pass over the gradients for the per-tensor norms and one pass that
reads p, g, m and v, writes p, m and v, and clears g where asked.

The launch table (``table_rows``) is plain Python over addresses and sizes,
so the CPU tests reach it.  ``Table`` keeps it on the device and rebuilds
it only when an address or a size in it changes (the first update, which
makes the moments; a state load that replaces a tensor; ZeRO-1 re-pointing
the optimizer), so a CUDA graph that captured the launches reads a table
that stays valid at every replay.  ``bert_adam.launches`` counts updates
(two launches, or one where the norms are given, counted as one).
"""
from __future__ import annotations

import ctypes
import functools
import struct
from typing import List, Optional, Sequence, Tuple

import torch

from medvill_torch.ops import build

# elements per chunk: one block of each launch
CHUNK = 32768
# a tensor's row in the table (csrc/bert_adam.cu: enum Field)
FIELDS = ("p", "g", "m", "v", "numel", "lr", "wd", "first", "count",
          "aligned")
ROW = len(FIELDS)

# (p, g or 0, m, v addresses; size; lr address; weight decay) of a tensor
Entry = Tuple[int, int, int, int, int, int, float]


def _f32_bits(x: float) -> int:
    """The float32 nearest ``x`` as a signed 32-bit integer."""
    return struct.unpack("<i", struct.pack("<f", x))[0]


def table_rows(entries: Sequence[Entry], chunk: int = CHUNK
               ) -> Tuple[List[int], int]:
    """(the table as int64 values, its number of chunks): per tensor a row
    of ``FIELDS`` (weight decay as float32 bits, 0 where it does not decay;
    ``aligned`` where every address is a multiple of 16 bytes), then per
    chunk (tensor, start): the tensor's elements cut into pieces of
    ``chunk``, the last one ragged, none for an empty tensor."""
    if chunk <= 0 or chunk % 4:
        raise ValueError(f"chunk must be a positive multiple of 4: {chunk}")
    rows: List[int] = []
    links: List[int] = []
    for t, (p, g, m, v, numel, lr, wd) in enumerate(entries):
        count = -(-numel // chunk)
        aligned = all(a % 16 == 0 for a in (p, g, m, v))
        rows += [p, g, m, v, numel, lr, _f32_bits(wd) if wd > 0 else 0,
                 len(links) // 2, count, int(aligned)]
        for c in range(count):
            links += [t, c * chunk]
    return rows + links, len(links) // 2


class Table:
    """The launch table of one optimizer on the device, with the norm
    launch's partial sums beside it."""

    def __init__(self):
        self.entries: Optional[List[Entry]] = None
        self.rows: Optional[torch.Tensor] = None
        self.partials: Optional[torch.Tensor] = None
        self.n_tensors = self.n_chunks = 0
        self.builds = 0

    def update(self, entries: List[Entry], device: torch.device) -> bool:
        """Rebuilds the table for ``entries`` unless it holds them already;
        returns whether it rebuilt."""
        if entries == self.entries:
            return False
        values, n_chunks = table_rows(entries)
        self.rows = torch.tensor(values, dtype=torch.int64).to(device)
        self.partials = torch.empty(max(n_chunks, 1), dtype=torch.float32,
                                    device=device)
        self.entries, self.n_tensors, self.n_chunks = (entries, len(entries),
                                                       n_chunks)
        self.builds += 1
        return True


@functools.cache
def _kernels():
    lib = build.library("bert_adam")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    norm, update = lib.medvill_bert_adam_norm, lib.medvill_bert_adam_update
    norm.argtypes = [p, i, i, i, p, p]
    update.argtypes = [p, i, i, i, p, p, i, f, f, f, f, f, f, i, p]
    norm.restype = update.restype = i
    return norm, update


def _check(tensors, device: torch.device) -> None:
    for p, g, m, v, lr, _ in tensors:
        for name, t in (("p", p), ("grad", g), ("m", m), ("v", v)):
            if t is None:
                continue
            if t.device != device or t.dtype != torch.float32 \
                    or not t.is_contiguous() or t.shape != p.shape:
                raise ValueError(
                    f"BertAdam kernel: {name} must be a contiguous f32 "
                    f"tensor of the parameter's shape {tuple(p.shape)} on "
                    f"{device}, got {t.dtype}{tuple(t.shape)} on {t.device}")
        if lr.device != device or lr.dtype != torch.float32 or lr.numel() != 1:
            raise ValueError(f"BertAdam kernel: lr must be one f32 on "
                             f"{device}")


def bert_adam(table: Table, tensors, *, b1: float, b2: float, eps: float,
              max_grad_norm: float, norms: Optional[torch.Tensor] = None,
              clear: bool = False) -> None:
    """One BertAdam update of ``tensors``, per trained tensor ``(p, grad or
    None, m, v, lr, weight_decay)`` (lr: the group's device scalar, already
    ``-lr * schedule``), in place on p, m and v; grad is zeroed where
    ``clear``.  Where ``max_grad_norm > 0`` each gradient is clipped by
    ``min(1, max_grad_norm / (||g|| + 1e-6))``, its norm taken here or read
    from ``norms`` (f32, one per tensor).  ``table`` is the caller's, kept
    from update to update."""
    if not tensors:
        return
    device = tensors[0][0].device
    if device.type != "cuda":
        raise ValueError(f"BertAdam kernel: no kernel for {device}")
    entries = [(p.data_ptr(), 0 if g is None else g.data_ptr(), m.data_ptr(),
                v.data_ptr(), p.numel(), lr.data_ptr(), float(wd))
               for p, g, m, v, lr, wd in tensors]
    if entries != table.entries:
        _check(tensors, device)
        table.update(entries, device)
    clip = max_grad_norm > 0
    if norms is not None and (norms.device != device or norms.dtype !=
                              torch.float32 or not norms.is_contiguous()
                              or norms.numel() != len(tensors)):
        raise ValueError(f"BertAdam kernel: norms must be {len(tensors)} "
                         f"contiguous f32 on {device}")
    norm, update = _kernels()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = 0
        if clip and norms is None:
            err = norm(table.rows.data_ptr(), table.n_tensors, table.n_chunks,
                       CHUNK, table.partials.data_ptr(), stream)
        if not err:
            err = update(
                table.rows.data_ptr(), table.n_tensors, table.n_chunks, CHUNK,
                table.partials.data_ptr(),
                None if norms is None or not clip else norms.data_ptr(),
                int(clip), b1, b2, 1.0 - b1, 1.0 - b2, eps, max_grad_norm,
                int(clear), stream)
    if err:
        raise RuntimeError(f"BertAdam kernel launch failed: CUDA error {err}")
    bert_adam.launches += 1


bert_adam.launches = 0
