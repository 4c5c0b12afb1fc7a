"""PyTorch/CUDA port of medvill_tpu for NVIDIA Hopper.

A separate package beside the JAX one: it imports torch and never jax or
medvill_tpu.  Ported so far: pretraining (cli/pretrain_main.py),
report-generation and VQA finetuning (cli/finetune_main.py), greedy,
sampled and beam decode with its scoring (cli/decode_main.py, eval/),
serving (cli/serve_main.py), MMBT classification
(cli/classification_main.py) and label-conditioned image-text retrieval
with the CNN_BERT baseline (cli/retrieval_main.py); torch_init.py reads
pretrained torch checkpoints; checkpoint.py saves and restores the whole
training state, so the pretrain and finetune CLIs resume after a
preemption bit for bit.  The mask-spec attention forward and backward and
the fused dropout+residual+LayerNorm forward and backward are hand-written
CUDA kernels (ops/csrc/).
"""
