"""PyTorch/CUDA port of medvill_tpu for NVIDIA Hopper.

A separate package beside the JAX one: it imports torch and never jax or
medvill_tpu.  Ported so far: pretraining (cli/pretrain_main.py),
report-generation and VQA finetuning (cli/finetune_main.py), greedy,
sampled and beam decode with its scoring (cli/decode_main.py, eval/) and
serving (cli/serve_main.py).  The mask-spec attention forward and backward
and the fused dropout+residual+LayerNorm forward and backward are
hand-written CUDA kernels (ops/csrc/).
"""
