"""Mask-spec attention: the forward kernel K1 and the backward kernel K2.

The counterpart of medvill_tpu/ops/flash_attention.py.  The mask is never
materialized: each sample carries a spec ``(variant, txt_len)`` and the
kernels compute visibility per element (``data.masks.visible``, the JAX
``_visible``, and nothing past ``l_real``), adding -10000 to the scaled
score of a masked cell.  Mask families: ``FAMILY_PRETRAIN``
(FULL/S2S/BAR/NONCROSS/ATTN1D over ``[CLS] img(N) [SEP] txt``) and
``FAMILY_SEQ2SEQ`` (finetune bi/s2s/bar with ``txt_len`` carrying
n_tokens).

- ``attn_fwd`` -> (o, lse): a CPU tensor takes ``attn_fwd_plain``; a CUDA
  tensor launches K1 (``csrc/flash_attention.cu``, replacing the TPU kernel
  ``_attn_fwd_kernel``) or raises.
- ``attn_bwd`` -> (dq, dk, dv): ``attn_bwd_plain`` on the CPU, K2 on the
  card (replacing ``_attn_bwd_kernel``): the recompute backward from q, k,
  v, the saved row log-sum-exp and the regenerated keep mask.
- ``flash_mha`` is the differentiable entry (a ``torch.autograd.Function``
  whose forward is ``attn_fwd`` and backward ``attn_bwd``);
  ``make_attention_fn`` adapts it to the BERT stack's ``attention_fn``
  hook and ignores the additive ``bias``.
- ``skipped_tiles`` reads back which tile pairs the kernels skipped, for
  the checks against ``masks.tile_skippable``.

Layout: q, k, v, o are [B, L, heads, D], the layout of the Q/K/V
projections' ``view``; the kernels read and write it directly at D = 64
(every BERT configuration of the reference).  A narrower head (the test
configurations' 16) is zero-padded to 64 around the launch, at the scale
1/sqrt(D): exact, at the cost of a copy (the TPU kernel takes any D).  The TPU
path pads L to 16/128 multiples and groups heads per block (with the
``MEDVILL_ATTN_*`` environment overrides); none of that tuning applies to
this kernel, which tiles L by ``TILE`` = 64 and masks the ragged edge
itself.  In bf16 the kernels run their tile products on the tensor cores
(bf16 operands, f32 accumulation; P and dS rounded to bf16 between
products, see ``bf16_tolerances``) and skip every (query tile, key tile)
pair the spec masks entirely (``masks.tile_skippable``), which changes no
bit; in f32 they keep f32 CUDA-core products.

Dropout keep mask: ``keep_mask`` below, a pure function of (seed, b, head,
r, c): kept iff ``fmix32(seed ^ (((b * heads + head) * L + r) * L + c)) >=
floor(rate * 2**32)`` in uint32 arithmetic, computed the same way by the
kernels, so K1, K2 and the plain versions agree bit for bit.  The seed is
an int or an ``ops.dropout.DeviceSeed``, which K1 and K2 read from device
memory (a CUDA graph that captured them draws a new mask per replay); the
plain versions take both forms and give the same mask for the same seed
value.  It does not reproduce the TPU PRNG; the JAX and torch outputs
agree only at rate 0.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from medvill_torch import parallel
from medvill_torch.data import masks
from medvill_torch.data.masks import FAMILY_PRETRAIN, FAMILY_SEQ2SEQ  # noqa: F401
from medvill_torch.ops import build
from medvill_torch.ops.dropout import (DeviceSeed, DropoutRNG, Seed,
                                       seed_args, seed_value)
from medvill_torch.ops.fused_ln import _M32, _fmix32, _threshold

NEG = -10000.0
HEAD_DIM = 64      # the kernel's head dim (kD in the source)
TILE = 64          # query and key rows per tile (kTile in the source)
BF16_U = 2.0 ** -8  # unit roundoff of bf16
_MAX_L = 4096


def score_bias(spec: torch.Tensor, L: int, img_block: int, l_real: int,
               family: int) -> torch.Tensor:
    """[B, 1, L, L] f32: 0 where visible, -10000 elsewhere."""
    r = torch.arange(L, device=spec.device).view(1, 1, L, 1)
    c = torch.arange(L, device=spec.device).view(1, 1, 1, L)
    vis = masks.visible(family, spec[:, 0].view(-1, 1, 1, 1),
                        spec[:, 1].view(-1, 1, 1, 1), r, c, img_block)
    return torch.where(vis & (c < l_real), 0.0, NEG)


def keep_mask(seed: Seed, B: int, heads: int, L: int, rate: float,
              device="cpu") -> torch.Tensor:
    """[B, heads, L, L] bool attention-dropout keep mask (see the module
    docstring)."""
    idx = torch.arange(B * heads * L * L, dtype=torch.int64,
                       device=device) & _M32
    bits = _fmix32(idx ^ seed_value(seed))
    return (bits >= _threshold(rate)).view(B, heads, L, L)


def _scores(q, k, spec, img_block, l_real, family):
    """Scaled scores plus the -10000 bias, [B, heads, L, L] f32."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    return s + score_bias(spec, q.shape[1], img_block, l_real, family)


def attn_fwd_plain(q, k, v, spec, *, img_block: int, l_real: int,
                   family: int, rate: float, seed: Seed):
    """The plain PyTorch version of K1: (o [B, L, heads, D] in q's dtype,
    lse [B, heads, L] f32).  Dropout acts on the probabilities before P.V;
    O is divided by the undropped row sum."""
    B, L, heads, _ = q.shape
    s = _scores(q, k, spec, img_block, l_real, family)
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(-1, keepdim=True)
    lse = (m + torch.log(l)).squeeze(-1)
    if rate > 0.0:
        keep = keep_mask(seed, B, heads, L, rate, q.device)
        e = torch.where(keep, e * (1.0 / (1.0 - rate)), 0.0)
    o = torch.einsum("bhqk,bkhd->bqhd", e, v.float())
    o = o / l.squeeze(-1).transpose(1, 2).unsqueeze(-1)
    return o.to(q.dtype), lse


def _bwd_terms(q, k, v, o, do, lse, spec, img_block, l_real, family, rate,
               seed):
    """(P_drop, dS), [B, heads, L, L] f32, of the recompute backward."""
    B, L, heads, _ = q.shape
    p = torch.exp(_scores(q, k, spec, img_block, l_real, family)
                  - lse.unsqueeze(-1))
    dof = do.float()
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.float())
    p_drop = p
    if rate > 0.0:
        keep = keep_mask(seed, B, heads, L, rate, q.device)
        inv = 1.0 / (1.0 - rate)
        p_drop = torch.where(keep, p * inv, 0.0)
        dp = torch.where(keep, dp * inv, 0.0)
    dvec = (dof * o.float()).sum(-1).transpose(1, 2).unsqueeze(-1)
    return p_drop, p * (dp - dvec)


def attn_bwd_plain(q, k, v, o, do, lse, spec, *, img_block: int,
                   l_real: int, family: int, rate: float, seed: Seed):
    """The plain PyTorch version of K2's recompute backward: (dq, dk, dv)
    in q's dtype.  P = exp(S - lse); dV = P_drop^T dO; dP = (dO V^T) * keep
    / (1 - rate); dS = P * (dP - rowsum(dO * O)); dQ = dS K * scale;
    dK = dS^T Q * scale."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    p_drop, ds = _bwd_terms(q, k, v, o, do, lse, spec, img_block, l_real,
                            family, rate, seed)
    dv = torch.einsum("bhqk,bqhd->bkhd", p_drop, do.float())
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def bf16_tolerances(q, k, v, o, do, lse, spec, plain: dict, *,
                    img_block: int, l_real: int, family: int, rate: float,
                    seed: Seed) -> dict:
    """Worst-case |kernel - plain version| of the bf16 kernels' o, dq, dk
    and dv, from where they round, with u = 2^-8 the unit roundoff of bf16
    (8 significant bits).  ``plain`` holds the plain versions' outputs;
    (o, lse) are what K2 is given.

    - Both sides round their output to bf16 once: u * max|out| each.
    - K1 rounds the kept probabilities (relative to the running max; O is
      divided by the row sum and multiplied by 1 / (1 - rate) in f32 at the
      end), each term by at most u of itself: u * max over (r, d) of
      sum_c P_drop[r, c] |v[c, d]|.
    - K2 rounds P_drop before dV += P_drop^T dO: u * max(P_drop^T |dO|);
      and dS before dK += dS^T Q and dQ += dS K: u * scale * max(|dS|^T
      |Q|) and u * scale * max(|dS| |K|).

    S, dP, the exponentials and every sum are f32 on both sides; their
    differences (summation order, exp2 against exp) are ~2^-20 relative,
    far inside the slack of a worst case that counts every rounding at its
    full size and with one sign."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    p_drop, ds = _bwd_terms(q, k, v, o, do, lse, spec, img_block, l_real,
                            family, rate, seed)
    ds = ds.abs()
    terms = {
        "o": torch.einsum("bhqk,bkhd->bqhd", p_drop, v.float().abs()),
        "dq": torch.einsum("bhqk,bkhd->bqhd", ds, k.float().abs()) * scale,
        "dk": torch.einsum("bhqk,bqhd->bkhd", ds, q.float().abs()) * scale,
        "dv": torch.einsum("bhqk,bqhd->bkhd", p_drop, do.float().abs())}
    return {n: BF16_U * (t.max().item()
                         + 2.0 * plain[n].float().abs().max().item())
            for n, t in terms.items()}


@functools.cache
def _kernels():
    lib = build.library("flash_attention")
    p, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
    fwd, bwd = lib.medvill_attn_fwd, lib.medvill_attn_bwd
    fwd.argtypes = [p] * 6 + [i] * 8 + [p, u, u, f, f, p]
    bwd.argtypes = [p] * 11 + [i] * 8 + [p, u, u, f, f, p]
    fwd.restype = bwd.restype = i
    return fwd, bwd


def _check(spec, *tensors) -> None:
    q = tensors[0]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"attention kernel takes f32 or bf16, got {q.dtype}")
    if q.dim() != 4 or q.shape[-1] != HEAD_DIM:
        raise ValueError(f"attention kernel takes [B, L, heads, D], D <= "
                         f"{HEAD_DIM}, got {tuple(q.shape)}")
    if not 1 <= q.shape[1] <= _MAX_L:
        raise ValueError(f"attention kernel takes 1 <= L <= {_MAX_L}, got "
                         f"{q.shape[1]}")
    for t in tensors:
        if t.dtype != q.dtype or t.shape != q.shape:
            raise TypeError(f"q/k/v/o/dO must match: {t.dtype}"
                            f"{tuple(t.shape)} vs {q.dtype}{tuple(q.shape)}")
        if t.device != q.device:
            raise ValueError(f"a tensor is on {t.device}, q on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("attention kernel inputs must be contiguous and "
                             "16-byte aligned")
    if spec.dtype != torch.int32 or tuple(spec.shape) != (q.shape[0], 2) \
            or spec.device != q.device or not spec.is_contiguous():
        raise TypeError(f"spec must be contiguous int32 [{q.shape[0]}, 2] on "
                        f"{q.device}, got {spec.dtype}{tuple(spec.shape)} on "
                        f"{spec.device}")


def _scalars(q, img_block, l_real, family, rate, seed, head_dim):
    B, L, heads, _ = q.shape
    return (B, L, heads, int(q.dtype == torch.bfloat16), int(img_block),
            int(l_real), int(family), int(rate > 0.0),
            *seed_args(seed, q.device), _threshold(rate), 1.0 / (1.0 - rate),
            1.0 / math.sqrt(head_dim))


def _widen(*tensors):
    """[B, L, heads, D < 64] tensors zero-padded to the kernels' head dim:
    a zero column adds nothing to a score, an output row or a gradient, so
    the kernel computes the narrow head exactly at the scale 1/sqrt(D)."""
    return [torch.nn.functional.pad(t, (0, HEAD_DIM - t.shape[-1]))
            for t in tensors]


def attn_fwd(q, k, v, spec, *, img_block: int, l_real: int, family: int,
             rate: float, seed: Seed):
    """(o, lse): the plain version for CPU tensors, K1 for CUDA ones."""
    if q.device.type == "cpu":
        return attn_fwd_plain(q, k, v, spec, img_block=img_block,
                              l_real=l_real, family=family, rate=rate,
                              seed=seed)
    if q.device.type != "cuda":
        raise ValueError(f"flash_mha: no kernel for {q.device}")
    d = q.shape[-1]
    if d < HEAD_DIM:
        q, k, v = _widen(q, k, v)
    _check(spec, q, k, v)
    B, L, heads, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(B, heads, L, device=q.device, dtype=torch.float32)
    with torch.cuda.device(q.device):
        err = _kernels()[0](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), spec.data_ptr(),
            o.data_ptr(), lse.data_ptr(),
            *_scalars(q, img_block, l_real, family, rate, seed, d),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"attention forward kernel failed: CUDA error "
                           f"{err}")
    attn_fwd.launches += 1
    return (o[..., :d].contiguous() if d < HEAD_DIM else o), lse


attn_fwd.launches = 0


def attn_bwd(q, k, v, o, do, lse, spec, *, img_block: int, l_real: int,
             family: int, rate: float, seed: Seed):
    """(dq, dk, dv): the plain version for CPU tensors, K2 for CUDA ones
    (three launches, counted as one)."""
    if q.device.type == "cpu":
        return attn_bwd_plain(q, k, v, o, do, lse, spec, img_block=img_block,
                              l_real=l_real, family=family, rate=rate,
                              seed=seed)
    if q.device.type != "cuda":
        raise ValueError(f"flash_mha: no kernel for {q.device}")
    d = q.shape[-1]
    if d < HEAD_DIM:
        q, k, v, o, do = _widen(q, k, v, o, do)
    _check(spec, q, k, v, o, do)
    B, L, heads, _ = q.shape
    if lse.dtype != torch.float32 or tuple(lse.shape) != (B, heads, L) \
            or not lse.is_contiguous() or lse.device != q.device:
        raise TypeError(f"lse must be contiguous f32 [{B}, {heads}, {L}]")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    dvec = torch.empty_like(lse)
    with torch.cuda.device(q.device):
        err = _kernels()[1](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), spec.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), dvec.data_ptr(),
            *_scalars(q, img_block, l_real, family, rate, seed, d),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"attention backward kernel failed: CUDA error "
                           f"{err}")
    attn_bwd.launches += 1
    if d < HEAD_DIM:
        return tuple(g[..., :d].contiguous() for g in (dq, dk, dv))
    return dq, dk, dv


attn_bwd.launches = 0


def skipped_tiles(q, k, v, do, spec, *, img_block: int, l_real: int,
                  family: int) -> dict:
    """Which (query tile, key tile) pairs ``attn_fwd`` and ``attn_bwd``
    skipped, read back from their outputs at rate 0: {"fwd", "dq", "dkdv"}
    -> bool [B, heads, n, n] (query tile, key tile), n = ceil(L / TILE).

    A pair that is computed carries a NaN in its key tile (or, for dK/dV,
    its query tile) into every row of its output tile, since a NaN score
    gives a NaN weight whether or not the cell is masked; a skipped pair
    never loads it.  So with the NaN in key tile j, the query tiles of o
    (K1) and dq (K2) that stay finite are those skipped against j; with it
    in query tile i, the finite key tiles of dk and dv.  The plain versions
    skip nothing."""
    B, L, heads, _ = q.shape
    n = -(-L // TILE)
    kw = dict(img_block=img_block, l_real=l_real, family=family, rate=0.0,
              seed=0)
    o, lse = attn_fwd(q, k, v, spec, **kw)

    def finite_tiles(x):  # [B, L, heads, D] -> [B, heads, n]
        f = x.isfinite().all(-1)
        f = torch.cat([f, f.new_ones(B, n * TILE - L, heads)], 1)
        return f.view(B, n, TILE, heads).all(2).transpose(1, 2)

    out = {name: torch.zeros(B, heads, n, n, dtype=torch.bool,
                             device=q.device) for name in ("fwd", "dq",
                                                           "dkdv")}
    for t in range(n):
        k_nan, q_nan = k.clone(), q.clone()
        k_nan[:, t * TILE:(t + 1) * TILE] = math.nan
        q_nan[:, t * TILE:(t + 1) * TILE] = math.nan
        out["fwd"][..., t] = finite_tiles(attn_fwd(q, k_nan, v, spec,
                                                   **kw)[0])
        out["dq"][..., t] = finite_tiles(attn_bwd(q, k_nan, v, o, do, lse,
                                                  spec, **kw)[0])
        _, dk, dv = attn_bwd(q_nan, k, v, o, do, lse, spec, **kw)
        out["dkdv"][:, :, t] = finite_tiles(dk) & finite_tiles(dv)
    return out


class _FlashMHA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, spec, img_block, l_real, family, rate, seed):
        kw = dict(img_block=img_block, l_real=l_real, family=family,
                  rate=rate, seed=seed)
        o, lse = attn_fwd(q, k, v, spec, **kw)
        ctx.save_for_backward(q, k, v, o, lse, spec)
        ctx.kw = kw
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, spec = ctx.saved_tensors
        dq, dk, dv = attn_bwd(q, k, v, o, do.contiguous(), lse, spec,
                              **ctx.kw)
        return dq, dk, dv, None, None, None, None, None, None


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              spec: torch.Tensor, *, img_block: int, l_real: int,
              family: int = FAMILY_PRETRAIN, dropout_rate: float = 0.0,
              seed: Seed = 0, deterministic: bool = True) -> torch.Tensor:
    """q/k/v: [B, L, heads, D]; spec: [B, 2] int32 (variant, txt_len);
    seed: an int or a ``DeviceSeed``.  Returns [B, L, heads, D] in q's
    dtype, differentiable in q, k, v."""
    rate = 0.0 if deterministic else float(dropout_rate)
    if not isinstance(seed, DeviceSeed):
        seed = int(seed)
    return _FlashMHA.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                           spec.to(torch.int32).contiguous(), int(img_block),
                           int(l_real), int(family), rate, seed)


def make_attention_fn(spec: torch.Tensor, img_block: int,
                      family: int = FAMILY_PRETRAIN,
                      dropout_rate: float = 0.0):
    """Adapter for the BERT stack's ``attention_fn`` hook: ignores the
    additive ``bias`` (the spec is the mask) and draws a fresh kernel seed
    from ``rng`` for each call with dropout on."""

    def fn(q, k, v, bias, rng: Optional[DropoutRNG] = None,
           deterministic: bool = True):
        del bias
        seed = 0
        if not deterministic and dropout_rate > 0.0:
            if rng is None:
                raise ValueError("attention dropout needs an rng")
            seed = rng.next_seed()
            # heads are local under tensor parallelism: fold the model rank
            seed = DeviceSeed(seed.base, parallel.model_seed_add(seed.add))
        return flash_mha(q, k, v, spec, img_block=img_block,
                         l_real=q.shape[1], family=family,
                         dropout_rate=dropout_rate, seed=seed,
                         deterministic=deterministic)

    return fn
