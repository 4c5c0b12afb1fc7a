"""Fused dropout + residual-add + LayerNorm: ``LN(dropout(x) + res)``.

``fused_dropout_add_ln`` has the signature and semantics of the JAX
package's (medvill_tpu/ops/fused_ln.py:185-215): ``[..., H]`` inputs, output
in x's dtype, f32 row statistics.  A CPU tensor goes to
``fused_dropout_add_ln_plain``; a CUDA tensor launches the Hopper kernel in
``csrc/fused_ln.cu`` (which replaces the TPU kernel ``_fwd_kernel``) or
raises.  There is no fallback from the card to the plain version.

Dropout keep mask: ``keep_mask`` below, a pure function of
``(seed, row, col)`` -- kept iff ``fmix32(seed ^ (row * H + col)) >=
floor(rate * 2**32)`` in uint32 arithmetic (murmur3's finaliser).  The
kernel computes the same bits, so kernel and plain version agree bit for bit
at any rate, and a backward kernel can regenerate the mask from the seed.
It does not reproduce the TPU PRNG's bits, which nothing can; the JAX and
torch outputs agree only at rate 0.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from medvill_torch.ops import build

_M32 = 0xFFFFFFFF
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


def keep_mask(seed: int, rows: int, h: int, rate: float,
              device="cpu") -> torch.Tensor:
    """[rows, h] bool dropout keep mask (see the module docstring)."""
    idx = torch.arange(rows * h, dtype=torch.int64, device=device) & _M32
    bits = _fmix32(idx ^ (int(seed) & _M32))
    return (bits >= _threshold(rate)).reshape(rows, h)


def fused_dropout_add_ln_plain(x: torch.Tensor, res: torch.Tensor,
                               gamma: torch.Tensor, beta: torch.Tensor, *,
                               rate: float, eps: float,
                               seed: int) -> torch.Tensor:
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


@functools.cache
def _kernel():
    fn = build.library("fused_ln").medvill_fused_ln_fwd
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, i, i, i, i, ctypes.c_uint32,
                   ctypes.c_uint32, ctypes.c_float, ctypes.c_float, p]
    fn.restype = i
    return fn


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


def fused_dropout_add_ln(x: torch.Tensor, res: torch.Tensor,
                         gamma: torch.Tensor, beta: torch.Tensor, *,
                         rate: float, eps: float, seed: int) -> torch.Tensor:
    """``LayerNorm(dropout(x) + res) * gamma + beta`` in one pass.

    x, res: [..., H] (f32 or bf16, same dtype); gamma, beta: [H] f32; seed:
    int (ignored when rate == 0).  Output dtype follows x.  Inference only:
    the backward kernel is not ported yet."""
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
        err = _kernel()(
            x.data_ptr(), res.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            y.data_ptr(), x.numel() // h, h, int(x.dtype == torch.bfloat16),
            int(rate > 0.0), int(seed) & _M32, thresh,
            1.0 / (1.0 - rate), eps,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"fused_ln kernel launch failed: CUDA error {err}")
    fused_dropout_add_ln.launches += 1
    return y


fused_dropout_add_ln.launches = 0
