"""Retrieval and classification metrics (a copy of
medvill_tpu/eval/metrics.py, numpy only).

Retrieval (reference: Downstream_task/Retrieval/full_dset_retrieval.py:250-339):
- `compute_ranks`: rank of the first aligned candidate in the
  similarity-sorted pool (Hit@K feeds off this);
- `compute_recall_precision`: R@K = hits-in-top-K / total-aligned,
  P@K = hits-in-top-K / K, K in {1,5,10};
- `compute_mrr`: mean(1 / (rank + 1));
- `evaluate_retrieval`: Hit@{1,5,10} + MRR + recall/precision.

Classification (reference: Classification/mmbt/main.py:138-193):
- per-class AUROC with mid-ranks for ties, micro/macro ROC-AUC and F1
  (no sklearn needed).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def compute_ranks(similarities: np.ndarray, labels: np.ndarray,
                  idx_lst: np.ndarray | None = None
                  ) -> List[int] | Tuple[List[int], List[list]]:
    """similarities/labels: [n_queries, pool_size].  Per query: sort
    descending, rank = index of first aligned candidate (pool_size if none)
    (reference: full_dset_retrieval.py:250-275).

    With ``idx_lst`` also returns the per-query ``Aligned_lst``
    ``[candidate_index, rank]`` the reference dumps to JSON
    (full_dset_retrieval.py:269,419-429)."""
    ranks = []
    aligned_lst = []
    for qi, (lab, sim) in enumerate(zip(labels, similarities)):
        inds = np.argsort(sim)[::-1]
        rank = sim.shape[-1]
        ind = inds[-1]
        for r, ind in enumerate(inds):
            if lab[ind] == 1:
                rank = r
                break
        ranks.append(rank)
        if idx_lst is not None:
            aligned_lst.append([int(idx_lst[qi][ind]), int(rank)])
    if idx_lst is not None:
        return ranks, aligned_lst
    return ranks


def compute_recall_precision(similarities: np.ndarray, labels: np.ndarray,
                             ks: Sequence[int] = (1, 5, 10)
                             ) -> Dict[str, Dict[str, float]]:
    """(reference: full_dset_retrieval.py:277-314)."""
    recall, precision = [], []
    for k in ks:
        r_lst, p_lst = [], []
        for lab, sim in zip(labels, similarities):
            inds = np.argsort(sim)[::-1]
            sorted_label = lab[inds]
            top = float(sorted_label[:k].sum())
            bottom = float(sorted_label.sum())
            r_lst.append(top / bottom if bottom else 0.0)
            p_lst.append(top / k)
        recall.append(float(np.mean(r_lst)))
        precision.append(float(np.mean(p_lst)))
    return {
        "recall": {f"R@{k}": round(v, 3) for k, v in zip(ks, recall)},
        # yes, the precision values are keyed "R@k" too — that is the
        # reference's own (quirky) dump format, kept for log compatibility
        # (full_dset_retrieval.py:309-313: 'i2t_precision': {"R@1": ...})
        "precision": {f"R@{k}": round(v, 3) for k, v in zip(ks, precision)},
    }


def compute_mrr(ranks: Sequence[int]) -> float:
    """(reference: full_dset_retrieval.py:316-324)."""
    r = np.asarray(ranks, dtype=float) + 1.0
    return float(np.mean(1.0 / r))


def evaluate_retrieval(similarities: np.ndarray, labels: np.ndarray,
                       direction: str = "i2t"
                       ) -> Tuple[dict, float, dict]:
    """Hit@{1,5,10} + MRR + R/P@K (reference:
    full_dset_retrieval.py:326-339)."""
    ranks = compute_ranks(similarities, labels)
    hits = {f"R@{k}": sum(r < k for r in ranks) / len(ranks)
            for k in (1, 5, 10)}
    mrr = compute_mrr(ranks)
    rp = compute_recall_precision(similarities, labels)
    return {f"{direction}_retrieval": hits}, mrr, rp


# ---------------------------------------------------------------------------
# Classification metrics (native AUROC/F1; the image has no sklearn).
# ---------------------------------------------------------------------------

def roc_auc(scores: np.ndarray, labels: np.ndarray) -> float:
    """Binary AUROC via the rank statistic (equivalent to sklearn's
    roc_auc_score up to tie handling, which we treat with midranks)."""
    scores = np.asarray(scores, dtype=np.float64)
    labels = np.asarray(labels).astype(bool)
    n_pos = labels.sum()
    n_neg = labels.size - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(scores)
    ranks = np.empty_like(order, dtype=np.float64)
    sorted_scores = scores[order]
    # midranks for ties
    i = 0
    r = np.arange(1, scores.size + 1, dtype=np.float64)
    while i < scores.size:
        j = i
        while j + 1 < scores.size and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[order[i:j + 1]] = r[i:j + 1].mean()
        i = j + 1
    return float((ranks[labels].sum() - n_pos * (n_pos + 1) / 2)
                 / (n_pos * n_neg))


def macro_roc_auc(scores: np.ndarray, labels: np.ndarray) -> float:
    aucs = [roc_auc(scores[:, c], labels[:, c])
            for c in range(labels.shape[1])]
    aucs = [a for a in aucs if not np.isnan(a)]
    return float(np.mean(aucs)) if aucs else float("nan")


def micro_roc_auc(scores: np.ndarray, labels: np.ndarray) -> float:
    return roc_auc(scores.ravel(), labels.ravel())


def f1_score(preds: np.ndarray, labels: np.ndarray,
             average: str = "micro") -> float:
    """Multilabel F1 (preds/labels: [N, C] in {0,1})."""
    preds = np.asarray(preds).astype(bool)
    labels = np.asarray(labels).astype(bool)
    if average == "micro":
        tp = (preds & labels).sum()
        fp = (preds & ~labels).sum()
        fn = (~preds & labels).sum()
        denom = 2 * tp + fp + fn
        return float(2 * tp / denom) if denom else 0.0
    # macro
    f1s = []
    for c in range(labels.shape[1]):
        tp = (preds[:, c] & labels[:, c]).sum()
        fp = (preds[:, c] & ~labels[:, c]).sum()
        fn = (~preds[:, c] & labels[:, c]).sum()
        denom = 2 * tp + fp + fn
        f1s.append(2 * tp / denom if denom else 0.0)
    return float(np.mean(f1s))


def classification_metrics(logits: np.ndarray, labels: np.ndarray,
                           threshold: float = 0.5,
                           label_names: Sequence[str] = ()) -> dict:
    """Per-class AUROC + micro/macro AUC/F1 (reference:
    mmbt/main.py:138-193; preds = sigmoid(logits) > 0.5)."""
    probs = 1.0 / (1.0 + np.exp(-np.asarray(logits, dtype=np.float64)))
    preds = probs > threshold
    out = {
        "micro_roc_auc": micro_roc_auc(probs, labels),
        "macro_roc_auc": macro_roc_auc(probs, labels),
        "micro_f1": f1_score(preds, labels, "micro"),
        "macro_f1": f1_score(preds, labels, "macro"),
    }
    names = (list(label_names) if label_names
             else [str(i) for i in range(labels.shape[1])])
    out["per_class_auroc"] = {
        n: roc_auc(probs[:, c], labels[:, c]) for c, n in enumerate(names)}
    return out


def vqa_score_with_logits(logits: np.ndarray, targets: np.ndarray
                          ) -> np.ndarray:
    """Soft VQA accuracy: one-hot(argmax) * soft targets, summed per example
    (reference: sc/pytorch_pretrained_bert/model.py:1014-1019)."""
    idx = np.argmax(logits, axis=1)
    return targets[np.arange(len(idx)), idx]
