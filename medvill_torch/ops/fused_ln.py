"""Fused dropout + residual-add + LayerNorm: ``LN(dropout(x) + res)``.

``fused_dropout_add_ln`` has the signature and semantics of the JAX
package's (medvill_tpu/ops/fused_ln.py:185-215): ``[..., H]`` inputs, output
in x's dtype, f32 row statistics, differentiable in x, res, gamma and beta.
Its forward is ``fused_ln_fwd`` and its backward ``fused_ln_bwd``: a CPU
tensor goes to the plain PyTorch version (``fused_dropout_add_ln_plain``,
``fused_dropout_add_ln_bwd_plain``); a CUDA tensor launches the Hopper
kernel in ``csrc/fused_ln.cu`` (K3, replacing the TPU kernel
``_fwd_kernel``; K4, replacing ``_bwd_kernel``) or raises.  There is no
fallback from the card to the plain version.  The backward recomputes the
keep mask and the row statistics from (x, res, seed), as the TPU kernel
does, so nothing but the inputs is saved.

Dropout keep mask: ``keep_mask`` below, a pure function of
``(seed, row, col)`` -- kept iff ``fmix32(seed ^ (row * H + col)) >=
floor(rate * 2**32)`` in uint32 arithmetic (murmur3's finaliser).  The
kernel computes the same bits, so kernel and plain version agree bit for bit
at any rate, and a backward kernel can regenerate the mask from the seed.
The seed is an int or an ``ops.dropout.DeviceSeed``, which K3 and K4 read
from device memory (so a CUDA graph that captured them draws a new mask
per replay); the plain versions take both forms and give the same mask for
the same seed value.  It does not reproduce the TPU PRNG's bits, which
nothing can; the JAX and torch outputs agree only at rate 0.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from medvill_torch.ops import build
from medvill_torch.ops.dropout import M32 as _M32
from medvill_torch.ops.dropout import (DeviceSeed, Seed, seed_args,
                                       seed_value)
_MAX_H = 1024


def _threshold(rate: float) -> int:
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    return int(rate * 2 ** 32)


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2**32 for int64 h < 2**32, in 16-bit halves so no int64
    product overflows."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def keep_mask(seed: Seed, rows: int, h: int, rate: float,
              device="cpu") -> torch.Tensor:
    """[rows, h] bool dropout keep mask (see the module docstring)."""
    idx = torch.arange(rows * h, dtype=torch.int64, device=device) & _M32
    bits = _fmix32(idx ^ seed_value(seed))
    return (bits >= _threshold(rate)).reshape(rows, h)


def fused_dropout_add_ln_plain(x: torch.Tensor, res: torch.Tensor,
                               gamma: torch.Tensor, beta: torch.Tensor, *,
                               rate: float, eps: float,
                               seed: Seed) -> torch.Tensor:
    """The plain PyTorch version of the kernel's arithmetic."""
    shape = x.shape
    h = shape[-1]
    x2 = x.reshape(-1, h).float()
    if rate > 0.0:
        keep = keep_mask(seed, x2.shape[0], h, rate, x.device)
        x2 = torch.where(keep, x2 * (1.0 / (1.0 - rate)), 0.0)
    s = x2 + res.reshape(-1, h).float()
    mean = s.mean(-1, keepdim=True)
    var = (s - mean).square().mean(-1, keepdim=True)
    y = (s - mean) * torch.rsqrt(var + eps) * gamma.float() + beta.float()
    return y.to(x.dtype).reshape(shape)


def fused_dropout_add_ln_bwd_plain(x: torch.Tensor, res: torch.Tensor,
                                   gamma: torch.Tensor, dy: torch.Tensor, *,
                                   rate: float, eps: float, seed: Seed):
    """The plain PyTorch version of K4's arithmetic: (dx, dres, dgamma,
    dbeta), dx in x's dtype, dres in res's, dgamma/dbeta f32."""
    shape = x.shape
    h = shape[-1]
    x2 = x.reshape(-1, h).float()
    keep = None
    if rate > 0.0:
        keep = keep_mask(seed, x2.shape[0], h, rate, x.device)
        x2 = torch.where(keep, x2 * (1.0 / (1.0 - rate)), 0.0)
    s = x2 + res.reshape(-1, h).float()
    mean = s.mean(-1, keepdim=True)
    var = (s - mean).square().mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    xhat = (s - mean) * rstd
    dy2 = dy.reshape(-1, h).float()
    dyg = dy2 * gamma.float()
    m1 = dyg.mean(-1, keepdim=True)
    m2 = (dyg * xhat).mean(-1, keepdim=True)
    ds = rstd * (dyg - m1 - xhat * m2)
    dx = ds if keep is None else torch.where(keep, ds * (1.0 / (1.0 - rate)),
                                             0.0)
    return (dx.to(x.dtype).reshape(shape), ds.to(res.dtype).reshape(shape),
            (dy2 * xhat).sum(0), dy2.sum(0))


@functools.cache
def _kernels():
    lib = build.library("fused_ln")
    p, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
    fwd, bwd = lib.medvill_fused_ln_fwd, lib.medvill_fused_ln_bwd
    occupancy = lib.medvill_fused_ln_bwd_occupancy
    fwd.argtypes = [p, p, p, p, p, i, i, i, i, p, u, u, f, f, p]
    bwd.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, p, u, u, f, f,
                    p]
    occupancy.argtypes = [i, i, ctypes.POINTER(ctypes.c_int)]
    fwd.restype = bwd.restype = occupancy.restype = i
    return fwd, bwd, occupancy


def _check(x, res, gamma, beta) -> None:
    h = x.shape[-1]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_ln kernel takes f32 or bf16 x, got {x.dtype}")
    if res.dtype != x.dtype or res.shape != x.shape:
        raise TypeError(f"res must match x: {res.dtype}{tuple(res.shape)} vs "
                        f"{x.dtype}{tuple(x.shape)}")
    for name, t in (("gamma", gamma), ("beta", beta)):
        if t.dtype != torch.float32 or tuple(t.shape) != (h,):
            raise TypeError(f"{name} must be f32 [{h}], got "
                            f"{t.dtype}{tuple(t.shape)}")
    for name, t in (("x", x), ("res", res), ("gamma", gamma), ("beta", beta)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    vec = 16 // x.element_size()
    if h % vec or h > _MAX_H:
        raise ValueError(f"fused_ln kernel takes H <= {_MAX_H} divisible by "
                         f"{vec} for {x.dtype}, got H={h}")


def fused_ln_fwd(x: torch.Tensor, res: torch.Tensor, gamma: torch.Tensor,
                 beta: torch.Tensor, *, rate: float, eps: float,
                 seed: Seed) -> torch.Tensor:
    """The forward: the plain version for CPU tensors, K3 for CUDA ones."""
    if x.device.type == "cpu":
        return fused_dropout_add_ln_plain(x, res, gamma, beta, rate=rate,
                                          eps=eps, seed=seed)
    if x.device.type != "cuda":
        raise ValueError(f"fused_dropout_add_ln: no kernel for {x.device}")
    _check(x, res, gamma, beta)
    thresh = _threshold(rate)
    h = x.shape[-1]
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _kernels()[0](
            x.data_ptr(), res.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            y.data_ptr(), x.numel() // h, h, int(x.dtype == torch.bfloat16),
            int(rate > 0.0), *seed_args(seed, x.device), thresh,
            1.0 / (1.0 - rate), eps,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"fused_ln kernel launch failed: CUDA error {err}")
    fused_ln_fwd.launches += 1
    return y


fused_ln_fwd.launches = 0

@functools.cache
def bwd_residency(device_index: int, h: int, bf16: bool) -> tuple:
    """(resident K4 blocks per SM, warps per block, SMs) at width ``h`` on
    CUDA device ``device_index``, from CUDA's occupancy calculator.  K4's
    persistent grid is at most blocks per SM x SMs, and a block takes one
    row per warp at a time."""
    out = (ctypes.c_int * 3)()
    with torch.cuda.device(device_index):
        err = _kernels()[2](h, int(bf16), out)
    if err or out[0] < 1:
        raise RuntimeError(f"fused_ln backward occupancy query failed: CUDA "
                           f"error {err}, {out[0]} blocks per SM")
    return tuple(out)


def bwd_grid(device_index: int, h: int, bf16: bool, rows: int) -> int:
    """K4's blocks for ``rows`` rows: the resident blocks, or fewer where
    the rows do not give each warp one."""
    per_sm, warps, sms = bwd_residency(device_index, h, bf16)
    return min(per_sm * sms, -(-rows // warps))


_tickets: dict = {}


def _ticket_buffer(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` zeroed uint32 tickets for K4's sum over blocks, one
    buffer per (device, stream).  The kernel leaves them at zero, so a buffer
    serves every later call on its stream, replays of a CUDA graph that
    captured a call included; K4 calls on one stream never overlap."""
    buf = _tickets.get((device.index, stream))
    if buf is None or buf.numel() < n:
        buf = torch.zeros(n, dtype=torch.int32, device=device)
        _tickets[(device.index, stream)] = buf
    return buf


def fused_ln_bwd(x: torch.Tensor, res: torch.Tensor, gamma: torch.Tensor,
                 dy: torch.Tensor, *, rate: float, eps: float, seed: Seed):
    """The backward, (dx, dres, dgamma, dbeta): the plain version for CPU
    tensors, K4 for CUDA ones.  K4 is one launch, dgamma and dbeta included,
    on a persistent grid (``bwd_grid``)."""
    if x.device.type == "cpu":
        return fused_dropout_add_ln_bwd_plain(x, res, gamma, dy, rate=rate,
                                              eps=eps, seed=seed)
    if x.device.type != "cuda":
        raise ValueError(f"fused_dropout_add_ln: no kernel for {x.device}")
    _check(x, res, gamma, gamma)
    if dy.dtype != x.dtype or dy.shape != x.shape or not dy.is_contiguous() \
            or dy.data_ptr() % 16 or dy.device != x.device:
        raise ValueError(f"dy must match x and be contiguous: "
                         f"{dy.dtype}{tuple(dy.shape)} on {dy.device}")
    thresh = _threshold(rate)
    h = x.shape[-1]
    rows = x.numel() // h
    bf16 = x.dtype == torch.bfloat16
    dx, dres = torch.empty_like(x), torch.empty_like(res)
    if rows == 0:
        dgamma, dbeta = torch.zeros(2, h, device=x.device)
        return dx, dres, dgamma, dbeta
    n_blocks = bwd_grid(x.device.index, h, bf16, rows)
    dgb = torch.empty(2, h, device=x.device, dtype=torch.float32)
    scratch = torch.empty(2 * n_blocks, 2 * h, device=x.device,
                          dtype=torch.float32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        tickets = _ticket_buffer(x.device, stream, n_blocks + 1)
        err = _kernels()[1](
            x.data_ptr(), res.data_ptr(), gamma.data_ptr(), dy.data_ptr(),
            dx.data_ptr(), dres.data_ptr(), dgb.data_ptr(),
            scratch.data_ptr(), tickets.data_ptr(), rows, h, n_blocks,
            int(bf16), int(rate > 0.0), *seed_args(seed, x.device), thresh,
            1.0 / (1.0 - rate), eps, stream)
    if err:
        raise RuntimeError(f"fused_ln backward kernel launch failed: CUDA "
                           f"error {err}")
    fused_ln_bwd.launches += 1
    return dx, dres, dgb[0], dgb[1]


fused_ln_bwd.launches = 0


class _FusedDropAddLN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, res, gamma, beta, rate, eps, seed):
        ctx.save_for_backward(x, res, gamma)
        ctx.args = (rate, eps, seed)
        return fused_ln_fwd(x, res, gamma, beta, rate=rate, eps=eps,
                            seed=seed)

    @staticmethod
    def backward(ctx, dy):
        x, res, gamma = ctx.saved_tensors
        rate, eps, seed = ctx.args
        dx, dres, dgamma, dbeta = fused_ln_bwd(
            x, res, gamma, dy.contiguous(), rate=rate, eps=eps, seed=seed)
        return dx, dres, dgamma, dbeta, None, None, None


def fused_dropout_add_ln(x: torch.Tensor, res: torch.Tensor,
                         gamma: torch.Tensor, beta: torch.Tensor, *,
                         rate: float, eps: float, seed: Seed) -> torch.Tensor:
    """``LayerNorm(dropout(x) + res) * gamma + beta`` in one pass.

    x, res: [..., H] (f32 or bf16, same dtype); gamma, beta: [H] f32; seed:
    an int or a ``DeviceSeed`` (ignored when rate == 0).  Output dtype follows x; differentiable in
    x, res, gamma and beta."""
    if not isinstance(seed, DeviceSeed):
        seed = int(seed)
    return _FusedDropAddLN.apply(x, res, gamma, beta, float(rate),
                                 float(eps), seed)
