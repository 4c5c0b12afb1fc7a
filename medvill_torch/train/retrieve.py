"""Retrieval: the train and score steps and the pool evaluation (the
counterpart of medvill_tpu/train/retrieve.py:24-206; reference:
full_dset_retrieval.py:341-510).

- Training concatenates the positives and the negatives on the batch
  (``data/retrieval.py::collate_pairs``) and minimizes the mean CE over the
  2-class ITM logits in f32 (``logsumexp - gold``), reporting the argmax
  accuracy.  The CXRBERT branch trains the ITM head and the encoder under
  AdamW (``train/optim.py::adamw``, lr only, as JAX's ``optim.adamw(lr)``);
  the frozen trunk runs under ``no_grad`` with train-mode BatchNorm, so its
  running statistics still move (JAX ``train_cnn=True``).  The CNN_BERT
  branch trains every parameter, the trunk included.
- Attention (CXRBERT branch): with ``use_flash_attention`` the mask-spec
  kernels under the batch's ``(FULL, txt_len)`` spec, family pretrain,
  img_block ``num_image_embeds + 2``, the config's attention dropout in
  training (K1 + K2 on a CUDA device, their plain versions on the CPU)
  and K1 alone at rate 0 in scoring; without it ``mha_reference`` on the
  dense bias.  The CNN_BERT text encoder always takes ``mha_reference`` on
  its dense bias, as JAX does.
- Scoring: ``softmax(logits)[:, 1]`` in f32, deterministic, running
  BatchNorm statistics.
- Random-pixel draws: each training step draws its pixel indices (and its
  dropout seed) from the host ``torch.Generator`` it is given; the score
  step uses one fixed draw from ``torch.Generator().manual_seed(0)``, where
  JAX uses ``PRNGKey(0)``.  Neither draw can match JAX's bits, as dropout
  cannot; with ``num_image_embeds == num_fibers`` both sorted draws are the
  identity, and ``loss_and_metrics`` / ``score`` take ``pixel_indices``
  so a test can hand both packages the same draw.
- ``run_retrieval_eval``: the scores of a candidate pool reshaped to
  ``[queries, eval_len_size]`` (a warning for trailing candidates that fill
  no pool), ``evaluate_retrieval``'s Hits@k, MRR and R/P@k, and the rank
  dump (one ``{"Rank", "Result"}`` line per aligned candidate).
"""
from __future__ import annotations

import json
import warnings
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from medvill_torch.config import RetrievalConfig
from medvill_torch.eval.metrics import compute_ranks, evaluate_retrieval
from medvill_torch.models.cnn_bert import CNNBert
from medvill_torch.models.cxrbert import CXRBERT
from medvill_torch.models.seq2seq import init_weights
from medvill_torch.ops.dropout import DropoutRNG
from medvill_torch.ops.flash_attention import (FAMILY_PRETRAIN,
                                               make_attention_fn)
from medvill_torch.train import optim
from medvill_torch.train.pretrain import (Batch, TrainState,
                                          sample_pixel_indices, to_device)


def build_model(cfg: RetrievalConfig) -> CXRBERT:
    return CXRBERT(cfg.bert, cfg.image)


def build_cnn_model(cfg: RetrievalConfig) -> CNNBert:
    return CNNBert(cfg.bert, n_classes=2)


def init_state(cfg: RetrievalConfig, cxr_bert: bool = True,
               seed: Optional[int] = None, device="cuda") -> TrainState:
    """A CXRBERT (or, without ``cxr_bert``, a CNN_BERT) with random weights
    from ``seed`` (``cfg.seed`` by default) on ``device``, and AdamW over
    its trainable parameters, applied every micro-step."""
    model = build_model(cfg) if cxr_bert else build_cnn_model(cfg)
    init_weights(model, cfg.seed if seed is None else seed,
                 cfg.bert.initializer_range)
    model.to(device)
    return TrainState(model, optim.Accumulate(
        optim.adamw(optim.trainable(model), cfg.lr), 1))


def itm_loss(logits: torch.Tensor, labels: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean CE over 2-class logits in f32, argmax accuracy)."""
    logits = logits.float()
    labels = labels.long()
    gold = torch.gather(logits, -1, labels.unsqueeze(-1)).squeeze(-1)
    loss = (torch.logsumexp(logits, dim=-1) - gold).mean()
    return loss, (logits.argmax(-1) == labels).float().mean()


def _attention_fn(cfg: RetrievalConfig, spec: torch.Tensor, rate: float):
    if not cfg.use_flash_attention:
        return None
    return make_attention_fn(spec, cfg.image.num_image_embeds + 2,
                             family=FAMILY_PRETRAIN, dropout_rate=rate)


def _itm_logits(model: CXRBERT, batch: Batch, pixel_indices, train: bool,
                attention_fn, rng: Optional[DropoutRNG]) -> torch.Tensor:
    return model.itm_forward(
        batch["cls_tok"], batch["input_txt"], batch["mask_spec"],
        batch["segment"], batch["image"], batch["sep_tok"],
        pixel_indices=pixel_indices, deterministic=not train,
        train_cnn=train, attention_fn=attention_fn, rng=rng)


def loss_and_metrics(model: CXRBERT, batch: Batch,
                     rng: Optional[DropoutRNG],
                     pixel_indices: Optional[torch.Tensor],
                     cfg: RetrievalConfig, attention_fn=None
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The CXRBERT training forward (dropout from ``rng``, train-mode
    BatchNorm) and its loss; metrics {"loss", "acc"} as device tensors."""
    if attention_fn is None:
        attention_fn = _attention_fn(
            cfg, batch["mask_spec"], cfg.bert.attention_probs_dropout_prob)
    logits = _itm_logits(model, batch, pixel_indices, True, attention_fn,
                         rng)
    loss, acc = itm_loss(logits, batch["is_aligned"])
    return loss, {"loss": loss, "acc": acc}


def _step(state: TrainState, loss: torch.Tensor,
          metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    loss.backward()
    state.tx.step()
    state.step += 1
    return {k: v.detach() for k, v in metrics.items()}


def make_train_step(cfg: RetrievalConfig
                    ) -> Callable[[TrainState, Batch, torch.Generator],
                                  Dict[str, torch.Tensor]]:
    """Returns ``train_step(state, batch, generator) -> {"loss", "acc"}``:
    one CXRBERT micro-step and its AdamW update.  Each call draws its pixel
    indices (random-pixel encoder) and its dropout seed from
    ``generator``."""

    def train_step(state: TrainState, batch: Batch,
                   generator: torch.Generator) -> Dict[str, torch.Tensor]:
        device = batch["input_txt"].device
        pixel_indices = None
        if cfg.image.encoder == "random-pixel":
            pixel_indices = sample_pixel_indices(
                generator, cfg.image.num_fibers,
                cfg.image.num_image_embeds).to(device)
        seed = int(torch.randint(0, 2 ** 31, (), generator=generator))
        return _step(state, *loss_and_metrics(
            state.model, batch, DropoutRNG(seed, device), pixel_indices, cfg))

    return train_step


def score_pixel_indices(cfg: RetrievalConfig) -> Optional[torch.Tensor]:
    """The score step's one fixed draw (None for a full-fiber encoder)."""
    if cfg.image.encoder != "random-pixel":
        return None
    return sample_pixel_indices(torch.Generator().manual_seed(0),
                                cfg.image.num_fibers,
                                cfg.image.num_image_embeds)


@torch.no_grad()
def score(model: CXRBERT, batch: Batch,
          pixel_indices: Optional[torch.Tensor],
          cfg: RetrievalConfig) -> torch.Tensor:
    """Alignment scores ``softmax(logits)[:, 1]``, f32 [B]."""
    if pixel_indices is not None:
        pixel_indices = pixel_indices.to(batch["input_txt"].device)
    logits = _itm_logits(model, batch, pixel_indices, False,
                         _attention_fn(cfg, batch["mask_spec"], 0.0), None)
    return torch.softmax(logits.float(), dim=-1)[:, 1]


def make_score_step(cfg: RetrievalConfig
                    ) -> Callable[[CXRBERT, Batch], torch.Tensor]:
    """Returns ``score_step(model, batch) -> scores [B]`` with the fixed
    pixel draw (``score_pixel_indices``)."""
    pixel_indices = score_pixel_indices(cfg)

    def score_step(model: CXRBERT, batch: Batch) -> torch.Tensor:
        return score(model, batch, pixel_indices, cfg)

    return score_step


def cnn_loss_and_metrics(model: CNNBert, batch: Batch,
                         rng: Optional[DropoutRNG]
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The CNN_BERT training forward (dropout from ``rng``, the trunk
    trained with train-mode BatchNorm) and its loss."""
    logits = model(batch["input_txt"], batch["attn_len"], batch["segment"],
                   batch["image"], deterministic=False, train_cnn=True,
                   rng=rng)
    loss, acc = itm_loss(logits, batch["is_aligned"])
    return loss, {"loss": loss, "acc": acc}


def make_cnn_train_step(cfg: RetrievalConfig
                        ) -> Callable[[TrainState, Batch, torch.Generator],
                                      Dict[str, torch.Tensor]]:
    """The CNN_BERT branch's ``train_step(state, batch, generator)``
    (reference: full_dset_retrieval.py:38,549-555)."""
    del cfg  # the step reads nothing of it; the signature matches

    def train_step(state: TrainState, batch: Batch,
                   generator: torch.Generator) -> Dict[str, torch.Tensor]:
        seed = int(torch.randint(0, 2 ** 31, (), generator=generator))
        return _step(state, *cnn_loss_and_metrics(
            state.model, batch,
            DropoutRNG(seed, batch["input_txt"].device)))

    return train_step


def make_cnn_score_step(cfg: RetrievalConfig
                        ) -> Callable[[CNNBert, Batch], torch.Tensor]:
    del cfg

    @torch.no_grad()
    def score_step(model: CNNBert, batch: Batch) -> torch.Tensor:
        logits = model(batch["input_txt"], batch["attn_len"],
                       batch["segment"], batch["image"], deterministic=True)
        return torch.softmax(logits.float(), dim=-1)[:, 1]

    return score_step


def run_retrieval_eval(score_step, model: torch.nn.Module,
                       batches: Iterable[Dict[str, np.ndarray]],
                       eval_len_size: int, direction: str = "i2t",
                       rank_dump_path: Optional[str] = None,
                       records: Optional[list] = None) -> dict:
    """Scores of every candidate of ``batches`` (numpy batches, moved to
    the model's device), reshaped to [queries, eval_len_size] and
    evaluated (full_dset_retrieval.py:577-643): {"hits", "mrr", R/P@k}.
    With ``rank_dump_path`` it appends one JSON line ``{"Rank": rank,
    "Result": <record>}`` per aligned candidate
    (full_dset_retrieval.py:419-429,591-613, written once where the
    reference writes it twice); without ``records`` the line carries the
    candidate index."""
    device = next(model.parameters()).device
    scores, labels, indices = [], [], []
    for batch in batches:
        scores.append(score_step(model, to_device(batch, device))
                      .float().cpu().numpy())
        labels.append(np.asarray(batch["is_aligned"]))
        if "index" in batch:
            indices.append(np.asarray(batch["index"]))
    scores = np.concatenate(scores)
    labels = np.concatenate(labels)
    n = (len(scores) // eval_len_size) * eval_len_size
    if n != len(scores):
        warnings.warn(
            f"retrieval eval: {len(scores) - n} trailing candidates do not "
            f"fill an eval_len_size={eval_len_size} pool and are excluded")
    sim = scores[:n].reshape(-1, eval_len_size)
    lab = labels[:n].reshape(-1, eval_len_size)
    hits, mrr, rp = evaluate_retrieval(sim, lab, direction)
    out = {"hits": hits, "mrr": mrr, **rp}
    if rank_dump_path and indices:
        idx = np.concatenate(indices)[:n].reshape(-1, eval_len_size)
        _, aligned_lst = compute_ranks(sim, lab, idx)
        with open(rank_dump_path, "a", encoding="utf-8") as f:
            for cand_idx, rank in aligned_lst:
                result = (records[cand_idx] if records is not None
                          else cand_idx)
                f.write(json.dumps({"Rank": rank, "Result": result},
                                   ensure_ascii=False) + "\n")
        out["rank_dump"] = rank_dump_path
    return out
