"""The pretraining loader's rows: ``cls_tok``, ``input_txt``,
``txt_labels``, ``mask_spec``, ``segment``, ``is_aligned``, ``sep_tok``.

The traffic file adds ``aligned_share``: the share of image-report pairs
labeled aligned (the ITM labels, drawn per pair).
"""
from __future__ import annotations

import numpy as np

from benchmark import traffic as tr
from benchmark.reference.masks import PRETRAIN_VARIANTS


def row(rng, n: int, dims: dict, variant: int,
        aligned_share: float) -> tr.Batch:
    """BERT's masking: each word is labeled with probability ``mlm_prob``;
    a labeled word becomes [MASK] (80%), a random id (10%) or stays
    (10%); a report with no label has its first word labeled and masked."""
    V, T = dims["vocab_size"], dims["seq_len"]
    I2 = dims["num_image_embeds"] + 2
    ids = tr.words(rng, n, V)
    labels = np.full(n, -100, np.int64)
    u = rng.random(n)
    r = rng.random(n)
    picked = u < dims["mlm_prob"]
    labels[picked] = ids[picked]
    ids = np.where(picked & (r < 0.8), tr.MASK, ids)
    swap = picked & (r >= 0.8) & (r < 0.9)
    ids = np.where(swap, rng.integers(0, V, n), ids)
    if not picked.any():
        labels[0], ids[0] = ids[0], tr.MASK
    pad = T - n
    return dict(
        cls_tok=np.array([tr.CLS], np.int32),
        input_txt=np.concatenate([ids, [tr.SEP], np.full(pad, tr.PAD)]
                                 ).astype(np.int32),
        txt_labels=np.concatenate([np.full(I2, -100), labels,
                                   np.full(pad + 1, -100)]).astype(np.int32),
        mask_spec=np.array([variant, n + 1], np.int32),
        segment=np.ones(T + 1, np.int32),
        is_aligned=np.int32(rng.random() < aligned_share),
        sep_tok=np.array([tr.SEP], np.int32))


def make_pool(traffic: dict, dims: dict, seed: int):
    variant = PRETRAIN_VARIANTS[dims["mask"]]
    return tr.reports(traffic, dims, seed, lambda rng, n: row(
        rng, min(n, dims["seq_len"]), dims, variant,
        traffic["aligned_share"]))
