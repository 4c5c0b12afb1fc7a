"""Report-generation / VQA finetune step (the counterpart of
medvill_tpu/train/finetune.py; reference: sc/finetune.py:421-470 over
``BertForPreTrainingLossMask.forward``, model.py:968-1054).

- report generation: gather ``masked_pos`` -> tied MLM head (``task_idx``
  under relax_projection) -> label smoothing (``cfg.label_smoothing`` > 0)
  or CE per position -> ``drop_worst_normalize`` at the epoch's ratio;
- VQA: BCE over the soft answer target of the classifier on ``h[:, 0]``,
  with the batch's soft score at the argmax;
- BertAdam (train/optim.py) over the trainable parameters, accumulated over
  ``gradient_accumulation_steps`` micro-batches, its lr schedule indexed by
  the optimizer step over ``t_total``;
- the frozen trunk's BatchNorm runs on batch statistics and updates the
  running ones (``train_cnn``), as JAX's ``train_cnn=True``.

With ``use_flash_attention`` (the default) attention runs the mask-spec
kernels K1/K2 in the seq2seq family (img_block = len_vis_input + 2);
otherwise ``mha_reference`` on ``finetune_bias``.  ``BertConfig.fused_ln``
selects K3/K4.  Each step's dropout seed comes from an explicit host
``torch.Generator``; ``dispatch.MultiStep`` of ``make_train_step`` runs k
micro-steps per dispatch (CUDA graphs on the card;
medvill_tpu/train/finetune.py:139 ``make_multi_train_step``).  The VQA
eval runs the dense bias, as JAX does.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from medvill_torch import parallel
from medvill_torch.config import FinetuneConfig
from medvill_torch.data.masks import NEG_BIAS, seq2seq_spec_dense
from medvill_torch.models.seq2seq import VLPForPreTraining, init_weights
from medvill_torch.ops.dropout import DropoutRNG
from medvill_torch.ops.flash_attention import (FAMILY_SEQ2SEQ,
                                               make_attention_fn)
from medvill_torch.train import optim
from medvill_torch.train.dispatch import MicroStep
from medvill_torch.train.losses import (bce_with_logits,
                                        cross_entropy_per_example,
                                        drop_worst_normalize,
                                        label_smoothing_loss)
from medvill_torch.train.pretrain import Batch, TrainState, to_device

_EVAL_KEYS = ("image", "input_ids", "segment_ids", "mask_spec")


def build_model(cfg: FinetuneConfig) -> VLPForPreTraining:
    return VLPForPreTraining(cfg.bert, cfg.image,
                             len_vis_input=cfg.len_vis_input, task=cfg.task,
                             n_answers=cfg.vqa_num_answers)


def init_state(cfg: FinetuneConfig, t_total: int,
               seed: Optional[int] = None, device="cuda") -> TrainState:
    """A model with random weights from ``seed`` (``cfg.seed`` by default)
    on ``device`` and its optimizer: BertAdam as ``make_finetune_tx``
    builds it over ``t_total`` updates, accumulated over
    ``gradient_accumulation_steps``."""
    model = build_model(cfg)
    init_weights(model, cfg.seed if seed is None else seed,
                 cfg.bert.initializer_range)
    model.to(device)
    tx = optim.Accumulate(
        optim.BertAdam(optim.decay_groups(model, cfg.weight_decay), cfg.lr,
                       t_total, warmup=cfg.warmup, schedule=cfg.sche_mode,
                       weight_decay=cfg.weight_decay),
        cfg.gradient_accumulation_steps)
    return TrainState(model, tx)


def finetune_bias(mask_spec: torch.Tensor, len_vis_input: int, max_len: int,
                  dtype=torch.float32) -> torch.Tensor:
    """[B, 2] (variant id, n_tokens) -> [B, 1, L, L] additive -10000
    bias."""
    dense = seq2seq_spec_dense(mask_spec[:, 0], mask_spec[:, 1],
                               len_vis_input, max_len)
    return ((1.0 - dense.to(dtype)) * NEG_BIAS)[:, None]


def drop_worst_ratio_for_epoch(cfg: FinetuneConfig, epoch0: int) -> float:
    """``max_drop_worst_ratio`` once the 1-based epoch exceeds
    ``drop_after``, else 0 (reference finetune.py:440); ``epoch0`` is
    0-based."""
    return cfg.max_drop_worst_ratio if epoch0 + 1 > cfg.drop_after else 0.0


def finetune_loss_and_metrics(model: VLPForPreTraining, batch: Batch,
                              rng: Optional[DropoutRNG],
                              cfg: FinetuneConfig,
                              drop_worst_ratio: float = 0.0,
                              attention_fn=None
                              ) -> Tuple[torch.Tensor,
                                         Dict[str, torch.Tensor]]:
    """The training forward (dropout from ``rng``, train-mode BatchNorm
    whose running statistics it updates in place) and its loss.  Metrics
    are device tensors: report generation masked_lm_loss, loss; VQA
    vqa_loss, batch_score, n, loss."""
    if attention_fn is None and cfg.use_flash_attention:
        attention_fn = make_attention_fn(
            batch["mask_spec"], cfg.len_vis_input + 2, family=FAMILY_SEQ2SEQ,
            dropout_rate=cfg.bert.attention_probs_dropout_prob)
    bias = (None if attention_fn is not None else
            finetune_bias(batch["mask_spec"], cfg.len_vis_input,
                          cfg.max_seq_length))
    kw = dict(deterministic=False, train_cnn=True, attention_fn=attention_fn,
              rng=rng)
    if cfg.task == "vqa":
        logits = model(batch["image"], batch["input_ids"],
                       batch["segment_ids"], bias, **kw)
        target = batch["ans_target"]
        loss = bce_with_logits(logits, target)
        if parallel.layout() is not None:
            # this rank's share: the sharded loader gives each rank as
            # many rows
            loss = loss / parallel.layout().data
        score = torch.gather(target, 1, logits.argmax(-1, keepdim=True))
        return loss, {"vqa_loss": loss, "batch_score": score.sum(),
                      "n": torch.full((), logits.shape[0],
                                      device=logits.device),
                      "loss": loss}
    logits = model(batch["image"], batch["input_ids"], batch["segment_ids"],
                   bias, masked_pos=batch["masked_pos"],
                   task_idx=batch.get("task_idx"), **kw)
    if cfg.label_smoothing > 0:
        per_pos = label_smoothing_loss(logits, batch["masked_ids"],
                                       cfg.label_smoothing,
                                       cfg.bert.vocab_size, ignore_index=0)
    else:
        per_pos = cross_entropy_per_example(logits, batch["masked_ids"])
    loss = drop_worst_normalize(per_pos, batch["masked_weights"],
                                drop_worst_ratio)
    return loss, {"masked_lm_loss": loss, "loss": loss}


def make_train_step(cfg: FinetuneConfig, drop_worst_ratio: float = 0.0
                    ) -> MicroStep:
    """Returns ``train_step(state, batch, generator) -> metrics``: one
    micro-step (forward, backward, and every
    ``gradient_accumulation_steps``-th call a BertAdam update).  Each call
    draws its dropout seed from the host ``generator``."""
    return MicroStep(lambda model, batch, rng, pix: finetune_loss_and_metrics(
        model, batch, rng, cfg, drop_worst_ratio))


def make_vqa_eval_step(cfg: FinetuneConfig
                       ) -> Callable[[VLPForPreTraining, Batch],
                                     torch.Tensor]:
    """VQA inference on the dense bias, running BatchNorm statistics and no
    dropout: the classifier over ``h[:, 0] * h[:, len_vis + 1]``
    (reference: model.py:979-984)."""

    @torch.no_grad()
    def eval_step(model: VLPForPreTraining, batch: Batch) -> torch.Tensor:
        bias = finetune_bias(batch["mask_spec"], cfg.len_vis_input,
                             cfg.max_seq_length)
        return model(batch["image"], batch["input_ids"],
                     batch["segment_ids"], bias, deterministic=True,
                     vqa_inference=True)

    return eval_step


def vqa_evaluate(eval_step, state: TrainState,
                 batches: Iterable[Dict[str, np.ndarray]]
                 ) -> Dict[str, float]:
    """Soft-score accuracy over numpy batches, split into closed (answer
    type 0) and open (reference: model.py:1021-1041)."""
    device = next(state.model.parameters()).device
    scores, types = [], []
    for batch in batches:
        use = to_device({k: batch[k] for k in _EVAL_KEYS}, device)
        idx = eval_step(state.model, use).argmax(-1).cpu().numpy()
        scores.append(np.asarray(batch["ans_target"])[np.arange(len(idx)),
                                                      idx])
        types.append(np.asarray(batch["ans_type"]))
    scores, types = np.concatenate(scores), np.concatenate(types)
    closed, opened = scores[types == 0], scores[types == 1]
    return {"vqa_acc": float(scores.mean()),
            "closed_acc": float(closed.mean()) if len(closed) else
            float("nan"),
            "open_acc": float(opened.mean()) if len(opened) else float("nan"),
            "n_closed": int(len(closed)), "n_open": int(len(opened))}
