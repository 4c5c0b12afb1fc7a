"""PyTorch/CUDA port of medvill_tpu for NVIDIA Hopper.

A separate package beside the JAX one: it imports torch and never jax or
medvill_tpu.  The ported slice so far is report-generation serving
(cli/serve_main.py) with the fused dropout+residual+LayerNorm forward as a
hand-written CUDA kernel (ops/csrc/fused_ln.cu).
"""
