"""Kinds of device operations, by the kernel's name (first match wins).

The name classes of ``tools/torch_pretrain_profile.py`` and
``tools/torch_serve_profile.py``, frozen here, plus ``batch_norm`` for the
trunk's BatchNorm kernels.  ``ANNOTATIONS`` are ranges that a profiler
shows on the device timeline (an optimizer's ``record_function``, the
profiler's steps): spans, not kernels.
"""
from __future__ import annotations

ANNOTATIONS = ("Optimizer.step#", "ProfilerStep#", "bench.")
KINDS = (("K1", ("attn_fwd_",)),
         ("K2", ("attn_bwd_",)),
         ("K3", ("fused_ln_fwd_kernel",)),
         ("K4", ("fused_ln_bwd_kernel",)),
         ("optimizer", ("multi_tensor", "adam")),
         ("convolution", ("conv", "cudnn", "implicit_gemm", "xmma_fprop",
                          "winograd")),
         ("gemm", ("gemm", "cutlass", "cublas", "sm90_xmma", "nvjet")),
         ("batch_norm", ("batch_norm",)),
         ("elementwise/reduction", ("elementwise", "reduce", "vectorized",
                                    "softmax", "norm", "index", "gather",
                                    "scatter", "copy", "fill", "cat",
                                    "sort", "where")))


def kind(name: str) -> str:
    low = name.lower()
    for k, keys in KINDS:
        if any(key in low for key in keys):
            return k
    return "other"
