"""Pretraining: one MLM + ITM training step (the counterpart of
medvill_tpu/train/pretrain.py).

loss = CE(MLM, ignore -100, mean over the labeled positions) + CE(ITM,
mean over the batch), AdamW with gradient accumulation, per-step MLM/ITM
accuracy counts kept on the device (reference: models/train_origin.py:
62,96-146).

- ``pretrain_loss_and_metrics`` takes ``pixel_indices`` as an argument, as
  the JAX function does, so a test can hand both the same draw.
- The MLM loss projects only the labeled text positions: a stable argsort
  puts them first and the first ``mlm_gather_bound`` (96) are gathered
  before the vocabulary projection.  With the bound at 0 or at least the
  text length it projects every text position: the same loss as the JAX
  package's chunked scan, which exists only to save TPU memory.
- ``make_train_step`` draws each step's pixel indices (a sorted
  ``randperm(M)[:N]`` shared by the batch) and its dropout seed from one
  explicit ``torch.Generator`` on the host; ``dispatch.MultiStep`` of
  it runs k of its micro-steps per dispatch (CUDA graphs on the card;
  medvill_tpu/train/pretrain.py:271 ``make_multi_train_step``).
- ``make_eval_step`` is the held-out MLM/ITM eval of the CLI's
  ``--test_dataset`` (medvill_tpu/train/pretrain.py:297-314): eval mode,
  no dropout, the trunk on its running statistics, K1 alone on the card.
- With ``use_flash_attention`` (the default) attention runs the mask-spec
  kernels K1/K2 (ops/flash_attention.py); otherwise ``mha_reference`` on
  the dense -10000 bias.  ``BertConfig.fused_ln`` selects K3/K4.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from medvill_torch import parallel
from medvill_torch.config import PretrainConfig
from medvill_torch.models.cxrbert import CXRBERT
from medvill_torch.models.seq2seq import init_weights
from medvill_torch.ops.dropout import DropoutRNG
from medvill_torch.ops.flash_attention import (FAMILY_PRETRAIN,
                                               make_attention_fn)
from medvill_torch.train import optim
from medvill_torch.train.dispatch import MicroStep

Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    """A model (``CXRBERT`` here, ``VLPForPreTraining`` in finetuning), its
    accumulating optimizer and the micro-steps taken."""

    model: torch.nn.Module
    tx: optim.Accumulate
    step: int = 0


def build_model(cfg: PretrainConfig) -> CXRBERT:
    return CXRBERT(cfg.bert, cfg.image, img_position=cfg.img_position)


def init_state(cfg: PretrainConfig, seed: Optional[int] = None,
               device="cuda") -> TrainState:
    """A model with random weights from ``seed`` (``cfg.seed`` by default)
    on ``device`` and its optimizer: AdamW over the trainable parameters
    (the frozen trunk excluded), accumulated over
    ``gradient_accumulation_steps`` micro-batches."""
    model = build_model(cfg)
    init_weights(model, cfg.seed if seed is None else seed,
                 cfg.bert.initializer_range)
    model.to(device)
    tx = optim.Accumulate(
        optim.adamw(optim.trainable(model), cfg.lr, cfg.beta1, cfg.beta2,
                    cfg.eps, cfg.weight_decay),
        cfg.gradient_accumulation_steps)
    return TrainState(model, tx)


def sample_pixel_indices(generator: torch.Generator, num_fibers: int,
                         num_image_embeds: int) -> torch.Tensor:
    """Random-pixel sampling: sorted randperm(M)[:N], one draw per step
    shared by the batch (reference: models/image.py:63-68)."""
    perm = torch.randperm(num_fibers, generator=generator)
    return torch.sort(perm[:num_image_embeds]).values


def _mlm_ce(logits: torch.Tensor, labels: torch.Tensor,
            across_ranks: bool = False):
    """Sum-then-mean CE over the labels that are not -100, with the count of
    correct argmaxes and of labels.  ``across_ranks``: the mean is over the
    labels of the global batch (their count summed over the data group),
    as JAX takes it over the global array (medvill_tpu/train/losses.py:
    35-36); each rank has its own count."""
    valid = labels != -100
    safe = torch.where(valid, labels, 0)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe.unsqueeze(-1)).squeeze(-1)
    nll = torch.where(valid, logz - gold, 0.0).sum()
    n = valid.sum()
    correct = ((logits.argmax(-1) == labels) & valid).sum()
    total = parallel.data_sum(n) if across_ranks else n
    return nll / total.clamp(min=1), correct, n


def _gathered_mlm_loss(model: CXRBERT, txt_hidden: torch.Tensor,
                       txt_labels: torch.Tensor, bound: int,
                       across_ranks: bool = False):
    """The MLM loss over the first ``bound`` labeled positions of each row
    (labeled positions first, original order kept: a stable argsort)."""
    valid = txt_labels != -100
    order = torch.argsort((~valid).to(torch.int8), dim=1, stable=True)
    idx = order[:, :bound]
    g_h = torch.take_along_dim(txt_hidden, idx.unsqueeze(-1), dim=1)
    g_l = torch.take_along_dim(txt_labels, idx, dim=1)
    return _mlm_ce(model.mlm_chunk(g_h).float(), g_l, across_ranks)


def pretrain_loss_and_metrics(model: CXRBERT, batch: Batch,
                              rng: Optional[DropoutRNG],
                              pixel_indices: Optional[torch.Tensor],
                              cfg: PretrainConfig, train: bool,
                              attention_fn=None
                              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, metrics) for one batch.  ``train`` turns on dropout (drawn
    from ``rng``) and BatchNorm on batch statistics, whose running
    statistics it updates in place.  Metrics are device tensors: mlm_loss,
    mlm_correct, mlm_total, itm_loss, itm_correct, itm_total, loss."""
    if attention_fn is None and cfg.use_flash_attention:
        attention_fn = make_attention_fn(
            batch["mask_spec"], cfg.image.num_image_embeds + 2,
            family=FAMILY_PRETRAIN,
            dropout_rate=cfg.bert.attention_probs_dropout_prob)
    sequence, pooled = model.features(
        batch["cls_tok"], batch["input_txt"], batch["mask_spec"],
        batch["segment"], batch["image"], batch["sep_tok"],
        pixel_indices=pixel_indices, deterministic=not train,
        train_cnn=train, disturbing=cfg.disturbing_mask,
        attention_fn=attention_fn, rng=rng)

    metrics: Dict[str, torch.Tensor] = {}
    total = torch.zeros((), device=sequence.device)
    across = train and parallel.layout() is not None
    if cfg.mlm_task:
        # image positions carry no labels (all -100): project text only
        I2 = cfg.image.num_image_embeds + 2
        txt_hidden = sequence[:, I2:]
        txt_labels = batch["txt_labels"][:, I2:].long()
        bound = cfg.mlm_gather_bound
        if bound and bound < txt_hidden.shape[1]:
            loss, correct, n = _gathered_mlm_loss(model, txt_hidden,
                                                  txt_labels, bound, across)
        else:
            loss, correct, n = _mlm_ce(model.mlm_chunk(txt_hidden).float(),
                                       txt_labels, across)
        total = total + loss
        metrics.update(mlm_loss=loss, mlm_correct=correct, mlm_total=n)
    if cfg.itm_task:
        logits = model.itm_logits(pooled)
        labels = batch["is_aligned"].long()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.unsqueeze(-1)).squeeze(-1)
        loss = (logz - gold).mean()
        if across:
            # this rank's share: the sharded loader gives each rank as
            # many rows
            loss = loss / parallel.layout().data
        total = total + loss
        n = torch.full((), labels.shape[0], device=labels.device)
        metrics.update(itm_loss=loss,
                       itm_correct=(logits.argmax(-1) == labels).sum(),
                       itm_total=n)
    metrics["loss"] = total
    return total, metrics


def pixel_draw(cfg) -> Optional[Callable[[torch.Generator], torch.Tensor]]:
    """A step's pixel-index draw from the host generator (random-pixel
    encoder), else None."""
    if cfg.image.encoder != "random-pixel":
        return None
    return lambda generator: sample_pixel_indices(
        generator, cfg.image.num_fibers, cfg.image.num_image_embeds)


def make_train_step(cfg: PretrainConfig) -> MicroStep:
    """Returns ``train_step(state, batch, generator) -> metrics``: one
    micro-step (forward, backward, and every
    ``gradient_accumulation_steps``-th call an AdamW update).  ``generator``
    is a host ``torch.Generator``: each call draws the pixel indices
    (random-pixel encoder) and the dropout seed from it."""
    return MicroStep(
        lambda model, batch, rng, pix: pretrain_loss_and_metrics(
            model, batch, rng, pix, cfg, train=True), pixel_draw(cfg))


def eval_pixel_indices(cfg: PretrainConfig) -> Optional[torch.Tensor]:
    """The eval's fixed pixel indices (random-pixel encoder), else None:
    one draw from ``torch.Generator().manual_seed(0)``.  JAX draws its
    fixed permutation from ``jax.random.PRNGKey(0)``, which no torch
    generator reproduces, so the two evals sample other fibers; handed the
    same indices (``make_eval_step(cfg, pixel_indices)``) they agree."""
    draw = pixel_draw(cfg)
    return None if draw is None else draw(torch.Generator().manual_seed(0))


def make_eval_step(cfg: PretrainConfig,
                   pixel_indices: Optional[torch.Tensor] = None
                   ) -> Callable[[CXRBERT, Batch], Dict[str, torch.Tensor]]:
    """Returns ``eval_step(model, batch) -> metrics``: the loss and the
    metrics of ``pretrain_loss_and_metrics`` (JAX's keys) in eval mode, no
    dropout, no gradient, the trunk on its running statistics, the pixel
    indices ``eval_pixel_indices(cfg)`` unless given."""
    if pixel_indices is None:
        pixel_indices = eval_pixel_indices(cfg)

    @torch.no_grad()
    def eval_step(model: CXRBERT, batch: Batch) -> Dict[str, torch.Tensor]:
        pix = None
        if pixel_indices is not None:
            pix = pixel_indices.to(next(model.parameters()).device)
        return pretrain_loss_and_metrics(model, batch, None, pix, cfg,
                                         train=False)[1]

    return eval_step


def to_device(batch, device) -> Batch:
    """A numpy batch from ``BatchLoader`` as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device, non_blocking=True)
            for k, v in batch.items()}
