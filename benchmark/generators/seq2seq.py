"""The report-generation loader's rows: ``input_ids``, ``segment_ids``,
``mask_spec``, ``masked_ids``, ``masked_pos``, ``masked_weights``,
``task_idx``."""
from __future__ import annotations

import numpy as np

from benchmark import traffic as tr
from benchmark.reference.masks import SEQ2SEQ_VARIANTS


def row(rng, n: int, dims: dict, variant: int) -> tr.Batch:
    """The s2s preprocessor: ``[CLS] [UNK]*N [SEP] report [SEP]`` with
    segments 4 and 5; ``min(max_pred, max(1, round(n * mlm_prob)))`` text
    positions (the final [SEP] among the candidates) become [MASK], with the
    final [SEP] forced in half of the reports; padded with 0."""
    V, N = dims["vocab_size"], dims["num_image_embeds"]
    L, P = dims["max_seq_length"], dims["max_pred"]
    if N + dims["max_len_b"] + 3 > L:
        raise ValueError("max_len_b does not fit the sequence")
    n = min(n, dims["max_len_b"])
    text = tr.words(rng, n, V)
    ids = np.concatenate([[tr.CLS], np.full(N, tr.UNK), [tr.SEP], text,
                          [tr.SEP]])
    n_tokens = len(ids)
    segment = np.concatenate([np.full(N + 2, 4), np.full(n + 1, 5)])
    n_pred = min(P, max(1, round(n * dims["mlm_prob"])))
    cand = rng.permutation(np.arange(N + 2, n_tokens))
    if rng.random() > 0.5:
        pos = np.concatenate([cand[:n_pred - 1], [n_tokens - 1]])
    else:
        pos = cand[:n_pred]
    masked_ids = ids[pos].copy()
    ids = ids.copy()
    ids[pos] = tr.MASK
    k = len(pos)
    return dict(
        input_ids=np.concatenate([ids, np.zeros(L - n_tokens)]
                                 ).astype(np.int32),
        segment_ids=np.concatenate([segment, np.zeros(L - n_tokens)]
                                   ).astype(np.int32),
        mask_spec=np.array([variant, n_tokens], np.int32),
        masked_ids=np.concatenate([masked_ids, np.zeros(P - k)]
                                  ).astype(np.int32),
        masked_pos=np.concatenate([pos, np.zeros(P - k)]).astype(np.int32),
        masked_weights=np.concatenate([np.ones(k), np.zeros(P - k)]
                                      ).astype(np.float32),
        task_idx=np.int32(3))


def make_pool(traffic: dict, dims: dict, seed: int):
    variant = SEQ2SEQ_VARIANTS[dims["mask"]]
    return tr.reports(traffic, dims, seed,
                      lambda rng, n: row(rng, n, dims, variant))
