"""The finetune and classification losses
(medvill_tpu/train/losses.py:39-109).

- ``cross_entropy_per_example``: unreduced CE, no ignore handling.
- ``label_smoothing_loss``: per position, KL(smoothed one-hot || softmax)
  summed over the vocabulary: the target gets ``1 - eps``, every other
  column ``eps / (V - 2)``, the ignore column 0, and a row whose label is
  the ignore index contributes 0 (reference:
  sc/pytorch_pretrained_bert/loss.py:12-48).
- ``drop_worst_normalize``: the masked-weight normalisation with
  Ruotian-Luo drop-worst: keep the ``int(B * (1 - ratio))`` examples of
  smallest summed loss, divide by their total weight + 1e-5 (reference:
  model.py:1003-1010).  Under data parallelism the
  examples kept and the weight divided by are the global batch's: every
  rank's summed losses are gathered, and each rank returns its kept
  examples' share (medvill_tpu/train/losses.py:76-92 over the global
  array).
- ``bce_with_logits``: the VQA soft-target BCE, mean over every element
  (reference: model.py:944).
- ``weighted_bce_with_logits``: ``BCEWithLogitsLoss(pos_weight=...)``, mean
  over every element, the classification loss (reference:
  mmbt/main.py:93-104).

A padded masked position gathers row 0 with label 0 and weight 0: it adds
0 through the weight in ``drop_worst_normalize`` and, with label smoothing,
through the ignore index 0 as well.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from medvill_torch import parallel


def cross_entropy_per_example(logits: torch.Tensor,
                              labels: torch.Tensor) -> torch.Tensor:
    """[..., V], [...] -> [...]."""
    logits = logits.float()
    gold = torch.gather(logits, -1, labels.long().unsqueeze(-1)).squeeze(-1)
    return torch.logsumexp(logits, dim=-1) - gold


def label_smoothing_loss(logits: torch.Tensor, labels: torch.Tensor,
                         smoothing: float, vocab_size: int,
                         ignore_index: int = 0) -> torch.Tensor:
    """[..., V], [...] -> [...]."""
    logp = F.log_softmax(logits.float(), dim=-1)
    labels = labels.long()
    true_dist = torch.full_like(logp, smoothing / (vocab_size - 2))
    true_dist.scatter_(-1, labels.unsqueeze(-1), 1.0 - smoothing)
    true_dist[..., ignore_index] = 0.0
    true_dist = true_dist * (labels != ignore_index).unsqueeze(-1)
    # torch's kl_div: target * (log target - input), 0 where target is 0
    kl = true_dist * (torch.log(true_dist + 1e-20) - logp)
    return kl.sum(-1)


def drop_worst_normalize(loss: torch.Tensor, weights: torch.Tensor,
                         drop_worst_ratio: float) -> torch.Tensor:
    """loss [B, P], weights [B, P] -> scalar."""
    loss = loss * weights
    if parallel.data_parallel():
        per = loss.sum(-1)
        every = parallel.gather_rows(per)
        keep = int(every.shape[0] * (1.0 - drop_worst_ratio))
        keep_idx = torch.topk(every, keep, largest=False).indices
        denom = parallel.gather_rows(weights.sum(-1))[keep_idx].sum() + 1e-5
        B, r = per.shape[0], parallel.layout().data_rank
        kept = torch.zeros_like(every, dtype=torch.bool).index_fill_(
            0, keep_idx, True)[r * B:(r + 1) * B]
        return (torch.where(kept, per, 0.0) / denom).sum()
    keep = int(loss.shape[0] * (1.0 - drop_worst_ratio))
    keep_loss, keep_idx = torch.topk(loss.sum(-1), keep, largest=False)
    denom = weights.sum(-1)[keep_idx].sum() + 1e-5
    return (keep_loss / denom).sum()


def bce_with_logits(logits: torch.Tensor,
                    targets: torch.Tensor) -> torch.Tensor:
    logits = logits.float()
    return torch.mean(torch.clamp(logits, min=0) - logits * targets
                      + torch.log1p(torch.exp(-logits.abs())))


def weighted_bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                             pos_weight: torch.Tensor) -> torch.Tensor:
    """[B, C], [B, C], [C] -> scalar."""
    logits = logits.float()
    loss = -(pos_weight * targets * F.logsigmoid(logits)
             + (1 - targets) * F.logsigmoid(-logits))
    return loss.mean()
