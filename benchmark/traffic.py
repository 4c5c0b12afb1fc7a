"""The general generator of a cell's input: a pool of batches in the form
the program's loaders hand to ``dispatch_loader``, drawn from the run's
seed and the parameters of a traffic file (``traffic/<mix>.json``).

A traffic file is data.  It names its ``runner`` (``runners/<runner>.py``)
and its ``format``: the generator ``generators/<format>.py`` whose
``make_pool(traffic, dims, seed)`` makes a batch's rows in the form of one
loader of the program, from the pieces here:

- ``report_wordpieces``: the report lengths, a log-normal of ``median``
  and ``sigma`` clipped to ``[min, max]``.  Every seed gets the same set of
  lengths (the distribution's quantiles at ``(i + 0.5) / n`` over the pool's
  n reports), in its own order, so that seeds change the order of the work
  and not its amount;
- ``pool_batches``: the batches of ``dims["batch_size"]`` rows the pool
  holds.

The model's side comes from the configuration (``dims``): the vocabulary,
the sequence layout, the mask variant, the MLM share and the image size.
Token ids are words of a synthetic 30522-entry wordpiece vocabulary whose
first five entries are [PAD] [UNK] [CLS] [SEP] [MASK]; images are random
grayscale pixels in three equal channels, uint8 NHWC.
"""
from __future__ import annotations

import math
import statistics
from typing import Callable, Dict, List

import numpy as np

from benchmark import harness

PAD, UNK, CLS, SEP, MASK = 0, 1, 2, 3, 4
FIRST_WORD = 5

Batch = Dict[str, np.ndarray]


def report_lengths(spec: dict, n: int, rng: np.random.Generator
                   ) -> np.ndarray:
    dist = statistics.NormalDist()
    q = [dist.inv_cdf((i + 0.5) / n) for i in range(n)]
    lengths = [min(spec["max"], max(spec["min"], round(
        spec["median"] * math.exp(spec["sigma"] * z)))) for z in q]
    return rng.permutation(np.array(lengths, dtype=np.int64))


def images(rng: np.random.Generator, B: int, size: int) -> np.ndarray:
    gray = np.frombuffer(rng.bytes(B * size * size), np.uint8)
    return np.repeat(gray.reshape(B, size, size, 1), 3, axis=-1)


def words(rng: np.random.Generator, n: int, vocab: int) -> np.ndarray:
    return rng.integers(FIRST_WORD, vocab, n, dtype=np.int64)


def reports(traffic: dict, dims: dict, seed: int,
            row: Callable[[np.random.Generator, int], Batch]
            ) -> List[Batch]:
    """The pool: ``pool_batches`` batches of ``row(rng, n)`` over the
    report lengths n, stacked, each with its random images."""
    rng = np.random.default_rng([seed, 0x7AF1C])
    B, n_batches = dims["batch_size"], traffic["pool_batches"]
    lengths = report_lengths(traffic["report_wordpieces"], n_batches * B,
                             rng)
    pool = []
    for b in range(n_batches):
        rows = [row(rng, int(n)) for n in lengths[b * B:(b + 1) * B]]
        batch = {k: np.stack([r[k] for r in rows]) for k in rows[0]}
        batch["image"] = images(rng, B, dims["img_size"])
        pool.append(batch)
    return pool


def make_pool(cell, seed: int) -> List[Batch]:
    """The cell's pool, from the generator its traffic file names."""
    gen = harness.plugin(cell, "generators", cell.traffic["format"])
    return gen.make_pool(cell.traffic, cell.dims, seed)
