"""The reference's arithmetic, in float32 (the reference) or in float8
where the program computes in bfloat16 (the control).

``Products("f32")`` multiplies float32 operands with TF32 off and rounds
nothing.  ``Products("fp8")`` is the step below the bfloat16 that the
configurations state.  Where the program casts a tensor to its compute
dtype (each operand of a product; ``act``: a product's or a convolution's
output, a LayerNorm's or BatchNorm's output, GELU's), the control rounds
it to float8 e4m3, and the gradient that flows back through that point to
float8 e5m2, as the program's cast makes that gradient bfloat16: float8
training's usual pair, each with one scale per tensor (its largest
magnitude at the format's largest finite value).  The arithmetic between
those points stays float32.  ``Products("bf16")`` rounds at the same
points to bfloat16, both ways: the reference at the precision that the
configurations state, a witness of what the program's own rounding
costs.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def tf32_off() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    scale = x.abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, grad):
        return _round(grad, torch.float8_e5m2, E5M2_MAX)


class _Bf16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad.to(torch.bfloat16).to(grad.dtype)


class Products:
    def __init__(self, mode: str = "f32"):
        if mode not in ("f32", "bf16", "fp8"):
            raise ValueError(f"precision {mode!r}: f32, bf16 or fp8")
        self.mode = mode

    def _q(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "fp8":
            return _Fp8.apply(x)
        return _Bf16.apply(x) if self.mode == "bf16" else x

    def act(self, x: torch.Tensor) -> torch.Tensor:
        """An activation the program holds in its compute dtype."""
        return self._q(x)

    def linear(self, x, w, b=None, act: bool = True):
        """``act=False``: the program keeps the output in float32."""
        y = F.linear(self._q(x), self._q(w), b)
        return self._q(y) if act else y

    def matmul(self, a, b):
        """float32 output (attention scores, MLM logits)."""
        return torch.matmul(self._q(a), self._q(b))

    def conv2d(self, x, w, stride: int, padding: int):
        return self._q(F.conv2d(self._q(x), self._q(w), None, stride,
                                padding))
