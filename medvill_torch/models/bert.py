"""BERT encoder stack in PyTorch (post-LN).

The counterpart of medvill_tpu/models/bert.py.  Module and parameter names
follow the reference's torch layout (``attention.self.query``,
``attention.output.LayerNorm``, ``intermediate.dense``, ``output.dense``,
...), so a reference ``state_dict`` loads without a remap.

Numerics follow the JAX package: parameters are f32, matmuls run in
``config.compute_dtype`` (operands cast, as flax ``Dense(dtype=...)`` does),
LayerNorm statistics and softmax are f32, GELU is the exact erf form in the
compute dtype.  ``prepare_for_compute`` (models/seq2seq.py) may store the
matmul weights in the compute dtype once, which makes the casts here no-ops.

Dropout follows the JAX modules: every forward takes ``deterministic``
(default True, the decode path) and, for training, a ``DropoutRNG``
(ops/dropout.py).  With ``deterministic=False`` the embeddings and the
hidden states are dropped at ``hidden_dropout_prob`` (Bernoulli masks from
``rng.generator``), the attention probabilities at
``attention_probs_dropout_prob`` (by ``mha_reference`` or, through
``attention_fn``, by the attention kernel with a seed from the rng), and
``FusedDropAddLN`` runs the fused kernel at ``hidden_dropout_prob`` with a
fresh seed per call.  ``remat``/``remat_mode`` (a memory knob) are not
ported; ``fused_qkv`` changes only the JAX parameter tree, not the math, so
it has no counterpart here.

The encoder takes an optional per-layer K/V cache that is written in place
at ``cache_index`` (JAX writes a new array with ``dynamic_update_slice``);
the updated caches are returned as well, so callers read like the JAX code.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from medvill_torch.config import BertConfig
from medvill_torch.ops.attention import mha_reference
from medvill_torch.ops.dropout import DropoutRNG, dropout
from medvill_torch.ops.fused_ln import fused_dropout_add_ln

KVCache = Tuple[torch.Tensor, torch.Tensor]


def compute_dtype(cfg: BertConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def dense(lin: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=dtype)``: input, kernel and bias in ``dtype``."""
    return F.linear(x.to(dtype), lin.weight.to(dtype), lin.bias.to(dtype))


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.LayerNorm(dtype=dtype)``: f32 statistics and affine (f64 on
    f64 input), output cast to ``dtype``."""
    return F.layer_norm(x.to(torch.promote_types(x.dtype, torch.float32)),
                        ln.normalized_shape, ln.weight, ln.bias,
                        ln.eps).to(dtype)


def maybe_dropout(x: torch.Tensor, rate: float, deterministic: bool,
                  rng: Optional[DropoutRNG]) -> torch.Tensor:
    """flax ``nn.Dropout(rate)(x, deterministic)``."""
    if deterministic or rate == 0.0:
        return x
    if rng is None:
        raise ValueError("dropout is on (deterministic=False) but no rng "
                         "was given")
    return dropout(x, rate, rng)


class BertEmbeddings(nn.Module):
    """word + position + token-type embeddings (f32) -> LayerNorm ->
    dropout.  Without ``position_ids`` positions are ``arange(L)``; without
    ``token_type_ids`` types are 0."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dtype = compute_dtype(cfg)
        self.dropout_rate = cfg.hidden_dropout_prob
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                  cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None,
                position_ids: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        B, L = input_ids.shape
        if position_ids is None:
            position_ids = torch.arange(
                L, device=input_ids.device).expand(B, L)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(position_ids)
             + self.token_type_embeddings(token_type_ids))
        return self.norm_and_drop(x, deterministic, rng)

    def norm_and_drop(self, x: torch.Tensor, deterministic: bool = True,
                      rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        """The shared LayerNorm and dropout (the image tokens of the joint
        encoder go through them too)."""
        x = layer_norm(self.LayerNorm, x, self.dtype)
        return maybe_dropout(x, self.dropout_rate, deterministic, rng)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.dtype = compute_dtype(cfg)
        self.query = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.key = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.value = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, hidden: torch.Tensor, bias: Optional[torch.Tensor],
                attention_fn=None, kv_cache: Optional[KVCache] = None,
                cache_index: Optional[int] = None, deterministic: bool = True,
                rng: Optional[DropoutRNG] = None
                ) -> Tuple[torch.Tensor, Optional[KVCache]]:
        """Returns (context [B, L, hidden], the updated cache or None).
        With a cache, the new K/V are written at [cache_index, +L) and
        attention runs over the whole cache (the bias masks what is not
        written yet).  ``attention_fn(q, k, v, bias, rng=, deterministic=)``
        replaces ``mha_reference`` (ops/flash_attention.py's
        ``make_attention_fn``)."""
        cfg = self.cfg
        B, L, _ = hidden.shape
        shape = (B, L, cfg.num_attention_heads, cfg.head_dim)
        q = dense(self.query, hidden, self.dtype).view(shape)
        k = dense(self.key, hidden, self.dtype).view(shape)
        v = dense(self.value, hidden, self.dtype).view(shape)
        if kv_cache is not None:
            ck, cv = kv_cache
            ck[:, cache_index:cache_index + L] = k
            cv[:, cache_index:cache_index + L] = v
            k, v = ck, cv
        if attention_fn is None:
            ctx = mha_reference(q, k, v, bias,
                                dropout_rate=cfg.attention_probs_dropout_prob,
                                deterministic=deterministic, rng=rng)
        else:
            ctx = attention_fn(q, k, v, bias, rng=rng,
                               deterministic=deterministic)
        return ctx.reshape(B, L, cfg.hidden_size), kv_cache


class FusedDropAddLN(nn.LayerNorm):
    """(dropout + residual-add + LayerNorm) as one kernel
    (ops/fused_ln.py), selected by ``BertConfig.fused_ln``.  A LayerNorm by
    parameters, so checkpoints are the same with and without it."""

    def __init__(self, cfg: BertConfig, width: int):
        super().__init__(width, eps=cfg.layer_norm_eps)
        self.dtype = compute_dtype(cfg)
        self.rate = cfg.hidden_dropout_prob

    def forward(self, x: torch.Tensor, res: torch.Tensor,
                deterministic: bool = True,
                rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        rate = 0.0 if deterministic else self.rate
        seed = 0
        if rate > 0.0:
            if rng is None:
                raise ValueError("dropout is on (deterministic=False) but no "
                                 "rng was given")
            seed = rng.next_seed()
        y = fused_dropout_add_ln(x, res, self.weight, self.bias, rate=rate,
                                 eps=self.eps, seed=seed)
        return y.to(self.dtype)


class BertSelfOutput(nn.Module):
    """dense -> (dropout) -> LayerNorm(x + residual).  Also serves as the
    FFN's ``output`` block (the reference's BertOutput has the same
    shape)."""

    def __init__(self, cfg: BertConfig, in_features: int):
        super().__init__()
        self.dtype = compute_dtype(cfg)
        self.dropout_rate = cfg.hidden_dropout_prob
        self.dense = nn.Linear(in_features, cfg.hidden_size)
        self.LayerNorm = (FusedDropAddLN(cfg, cfg.hidden_size) if cfg.fused_ln
                          else nn.LayerNorm(cfg.hidden_size,
                                            eps=cfg.layer_norm_eps))

    def forward(self, x: torch.Tensor, residual: torch.Tensor,
                deterministic: bool = True,
                rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        x = dense(self.dense, x, self.dtype)
        if isinstance(self.LayerNorm, FusedDropAddLN):
            return self.LayerNorm(x, residual, deterministic, rng)
        x = maybe_dropout(x, self.dropout_rate, deterministic, rng)
        return layer_norm(self.LayerNorm, x + residual, self.dtype)


class BertAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.self = BertSelfAttention(cfg)
        self.output = BertSelfOutput(cfg, cfg.hidden_size)


class BertIntermediate(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dtype = compute_dtype(cfg)
        self.dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # exact erf-GELU in the compute dtype (medvill_tpu bert.py:273)
        return F.gelu(dense(self.dense, x, self.dtype))


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.attention = BertAttention(cfg)
        self.intermediate = BertIntermediate(cfg)
        self.output = BertSelfOutput(cfg, cfg.intermediate_size)

    def forward(self, hidden: torch.Tensor, bias: Optional[torch.Tensor],
                attention_fn=None, kv_cache: Optional[KVCache] = None,
                cache_index: Optional[int] = None, deterministic: bool = True,
                rng: Optional[DropoutRNG] = None
                ) -> Tuple[torch.Tensor, Optional[KVCache]]:
        ctx, new_cache = self.attention.self(
            hidden, bias, attention_fn=attention_fn, kv_cache=kv_cache,
            cache_index=cache_index, deterministic=deterministic, rng=rng)
        attn_out = self.attention.output(ctx, hidden, deterministic, rng)
        out = self.output(self.intermediate(attn_out), attn_out,
                          deterministic, rng)
        return out, new_cache


class BertEncoder(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(cfg)
                                   for _ in range(cfg.num_hidden_layers))

    def forward(self, hidden: torch.Tensor, bias: Optional[torch.Tensor],
                attention_fn=None,
                kv_caches: Optional[List[KVCache]] = None,
                cache_index: Optional[int] = None, deterministic: bool = True,
                rng: Optional[DropoutRNG] = None
                ) -> Tuple[torch.Tensor, Optional[List[KVCache]]]:
        new_caches = [] if kv_caches is not None else None
        for i, layer in enumerate(self.layer):
            cache = kv_caches[i] if kv_caches is not None else None
            hidden, new_cache = layer(hidden, bias, attention_fn=attention_fn,
                                      kv_cache=cache, cache_index=cache_index,
                                      deterministic=deterministic, rng=rng)
            if new_caches is not None:
                new_caches.append(new_cache)
        return hidden, new_caches


class BertPooler(nn.Module):
    """dense + tanh over position 0."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dtype = compute_dtype(cfg)
        self.dense = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        x = dense(self.dense, hidden[:, 0], self.dtype)
        return torch.tanh(x.float()).to(self.dtype)
