"""Smoke run of the medvill_torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as one JSON line; any failure exits non-zero:

1. build: every kernel under medvill_torch/ops/csrc/ with nvcc (one process
   per source, all at once), with ptxas' registers and spills per kernel
   (none in the bf16 attention kernels and in any K4 instantiation).
2. kernel: the fused dropout+residual+LayerNorm kernel against its plain
   PyTorch version at the serve path's shapes (prefill R = 8*258, decode
   window R = 8*2, H = 768) in f32 (max abs err <= 1e-5) and bf16 (<= one
   bf16 ulp of max|y|, 2^-7 * max|y|); the rate-0.1 keep mask read back from
   the kernel equals the plain mask bit for bit, and keeps 0.9 +- 0.005.
   Device times from CUDA graphs of 100 calls (host launch cost excluded),
   L2-warm (the serve path feeds the kernel straight from a GEMM): kernel,
   plain version, and F.layer_norm(x + res) as the library yardstick; also
   the per-call time of eager back-to-back calls, host cost included;
   bound = (2 reads + 1 write) * R * H * bytes / 3.35 TB/s.
3. serve: a synthetic 30522-token vocab and a random full-width checkpoint
   (BERT-base VLP, ResNet-50 at 512 px, 256 fibers), written by the port;
   the port's HTTP server with {"fused_ln": true} at batch 8 answers 12
   concurrent POST /generate requests (one full and one padded batch); every
   reply is 200 with a string caption, and the fused kernel ran exactly
   24 * (1 + 128) times per decoded batch.
4. parity: the same weights in f32 compute (TF32 off), prefill plus the first
   decode window, fused LN on (the kernel) vs off (plain LayerNorm) on the
   card, and the card against the CPU: logits max abs err <= 1e-3.

5. kernel-attn: the attention kernels K1 (forward) and K2 (backward)
   against their plain versions at the pretrain shape (B = 36, L = 436,
   12 x 64; each of the five pretrain mask variants) and at a finetune shape
   (B = 4, L = 512, img_block 258; the three seq2seq modes), f32 and bf16,
   dropout 0 and 0.1.  Tolerances: f32 o 1e-5, lse 1e-4, dq/dk/dv 1e-4
   (summation order); bf16 the worst case of where the tensor-core kernels
   round (P and dS to bf16 between products; fa.bf16_tolerances), lse 1e-4.
   The rate-0.1 keep mask read back from K1 (q = k = 0, V one-hot over a
   window of 64 keys) equals the plain mask bit for bit, in f32 and bf16;
   two K2 calls agree bit for bit.  Library yardstick (training shape,
   BAR, rate 0, bf16): K1/K2 and autograd through
   F.scaled_dot_product_attention against the plain version on f32 copies
   of the same inputs; the kernel's error, largest and root mean square,
   is at most twice the library's for o, dq, dk, dv.  Times at the pretrain shape, bf16, BAR, dropout 0.1:
   device times from CUDA graphs for kernel, plain version and
   F.scaled_dot_product_attention with the same -10000 bias at rate 0
   (autograd through it for K2, the backward captured on its forward's
   stream), achieved TFLOP/s, the share of tile pairs skipped (read back
   from K1 and both K2 tile kernels by NaN probes, fa.skipped_tiles, and
   equal to masks.tile_skippable pair by pair), eager per-call times, the
   kernels' times at rate 0 (the library's conditions) and the f32
   kernels' times.  Then K1/K2 at the finetune step's call (B = 4, L =
   512, s2s, bf16, rate 0.1): against the plain versions, and timed beside
   their plain versions and the library.  Then at the classification
   step's call (B = 56, L = 258 + 256 = 514, FULL, img_block 258, text
   lengths 1..256): against the plain versions in f32 and bf16 at rates 0
   and 0.1, the skipped tile pairs read back and equal to the predicate,
   and timed (bf16, rate 0.1) beside the bound, the plain versions and the
   library.  Then the same at the retrieval step's call (B = 140: 70
   positives and 70 negatives, L = 436, FULL, img_block 182, text lengths
   1..254 from a seeded numpy draw), and K1 at its scoring call (B = 70,
   rate 0) against its plain version and timed.  Each bound and achieved TFLOP/s counts the work the call's
   masks leave: the visible (query, key) cells for the operations (K1 4,
   K2 10 per cell and head dimension), and for the bytes q, o, lse (K2
   also dO and dq, dk, dv) in full but only the k and v rows that some
   query sees.
6. kernel-ln-bwd: the fused-LN backward K4 against its plain version and
   against autograd through the plain forward, and K3 with dropout 0.1,
   at the training shape R = 36 * 436 = 15696, H = 768, f32 and bf16,
   rate 0 and 0.1; dx zero where the forward dropped x; two K4 calls
   bit-identical; K4's registers (ptxas), blocks per SM, warps and grid;
   device times from CUDA graphs beside the bound and the library's
   (autograd through F.layer_norm(x + res) for K4, F.layer_norm(x + res)
   for K3), and eager per-call times.  Then K4 at its grid's edges, rate
   0.1: 1 and 15697 rows at H 768 bf16, 15697 at H 1024 bf16, 1 and 15697
   at H 32 f32.  Then K3/K4 at the finetune step's call (R = 4 * 512, bf16,
   rate 0.1, eps 1e-5), checked and timed the same way.
7. train: python -m medvill_torch.cli.pretrain_main's entry point at the
   full configuration (BERT-base, ResNet-50 at 512 px, 180 random-pixel
   embeds, seq_len 253 so L = 436, BAR, batch 36, accumulation 4, AdamW lr
   1e-5) on 288 synthetic records (8 micro-steps = 2 optimizer steps):
   finite losses, a checkpoint written, pairs/s and peak memory, and
   exactly 12 K1 and 12 K2 launches per micro-step.
8. train-fused: the same trainer through medvill_torch.train.pretrain with
   fused_ln on, 4 micro-steps on one repeated batch: the loss falls and K3
   and K4 run exactly 24 times each per micro-step; then the steady-state
   ms per micro-step with fused_ln on and off.
9. train-parity: one step at full width, batch 4, fused_ln on, dropout
   0.1: the kernel path against the plain path (the same model with the
   plain versions swapped in) from the same seeds.  f32 with TF32 off: loss
   within 1e-4 relative, every gradient within 1e-3 of its tensor's largest
   entry (a key bias, whose exact gradient is 0, of its layer's key
   weights' largest entry).  bf16: the loss's distance within twice the
   plain path's own bf16-vs-f32 distance, and tensor by tensor (key biases
   aside) the gradient's distance within twice that tensor's bf16-vs-f32
   distance.
10. finetune: python -m medvill_torch.cli.finetune_main's entry point at its
   defaults (BERT-base VLP, 6 token types, LN eps 1e-5, ResNet-50 at 512 px
   with 256 fibers, L = 512, s2s masks, batch 4, max_pred 128, BertAdam lr
   3e-5, label smoothing 0.1) with {"fused_ln": true}, recovering the
   train phase's pretrain model.0.bin, one epoch over its first 32 records
   (8 micro-steps): token-type rows 2, 3, 4 recovered from pretrain row 0
   and row 5 from row 1; finite losses; exactly 12 K1, 12 K2, 24 K3 and 24
   K4 launches per micro-step; model.0.bin written in the reference VLP
   layout loads strictly, and a greedy decode of 2 images x 16 tokens from
   it gives finite log-probabilities.  Reports/s, ms per micro-step, peak
   memory.
11. finetune-steps: medvill_torch.train.finetune on one repeated batch, a
   generator of the same seed per step, lr 1e-4, t_total 4, 5 micro-steps:
   the second loss equals the first within 1e-6 relative (the first update
   has lr 0) and the last is below the first; 2 VQA micro-steps (458
   answers) on synthetic questions over the same images and the VQA eval
   (finite accuracies); then the steady ms per micro-step, fused_ln on and
   off.
12. finetune-parity: train-parity's method on one report-generation step,
   batch 4 (rows s2s, s2s, bi, bar), fused_ln on, dropout 0.1, with the same
   f32 and bf16 legs and tolerances.
13. decode: the decode CLI over the finetune records at batch 8, 128
   tokens, greedy and then beam 4 with trigram forbidding, each with
   exactly 24 * 129 K3 launches per batch; then beam_search on one batch
   with fused_ln on vs off: f32 ids equal, scores within 1e-4 relative and
   within 1e-3 of their teacher-forced rescoring in the beam's geometry;
   bf16 scores finite, the rows that agree reported.
14. classify: python -m medvill_torch.cli.classification_main's entry
   point at its defaults (BERT-base, the ResNet-50 trunk trained at 512 px
   with 256 fibers, FULL over L = 514, batch 56, weighted BCE, BertAdam lr
   1e-4 with warmup and the plateau scale) on a synthetic fixture over the
   14 CheXpert labels (2 train batches, one valid and one test batch,
   reports of 20-300 words), --loaddir the train phase's checkpoints, one
   epoch and --do_test: every shared enc.* tensor merged; exactly 12 K1 +
   12 K2 launches per micro-step and 12 K1 per eval batch, no K3/K4; a
   finite loss; finite F1 and AUROC (nan only for a class with one label
   value in the split); the CSV, model.0.bin (the MMBT layout) and
   model.best.bin written; examples/s and peak memory.
15. clf-steps: the classification step on one device-resident batch of
   56: steady ms per micro-step with fused_ln off and on (with it 24 K3 +
   24 K4 launches per micro-step) and peak memory; then train-parity's f32
   leg on one step at batch 4 with the trunk trained.

16. retrieve: python -m medvill_torch.cli.retrieval_main's entry point at
   its defaults (CXRBERT: BERT-base, the ResNet-50 trunk frozen at 512 px
   with 180 random-pixel embeds, FULL over L = 436, 70 label-conditioned
   pairs = 140 rows, AdamW lr 1e-5), --load_pretrained_model the train
   phase's model.0.bin, one epoch over 140 records (2 micro-steps),
   --eval_during_training on 2 pools and --do_test on 3, each of 140
   candidates (--eval_len_size 140: the pool size is data; the CLI's
   default is 759): exactly 12 K1 + 12 K2 per micro-step and 12 K1 per
   scored batch of 70, no K3/K4; a finite loss; Hits@k and MRR in [0, 1];
   one rank-dump line per query; model.0.bin loads strictly; examples/s
   (2 x 70 per micro-step), candidates/s, peak memory.
17. retr-steps: the retrieval step on one device-resident batch of 140
   rows: steady ms per micro-step and peak memory, the score step's ms per
   batch of 70; then train-parity's f32 leg on one step of 2 pairs
   (fused_ln on, dropout 0.1, the kernels against the plain path).
18. retrieve-cnn: the retrieval CLI's --CXRBERT false branch (CNN_BERT,
   the trunk trained) at its default 70 pairs (140 trained images; train-
   mode BatchNorm keeps only its bf16 input and per-channel statistics for
   the backward), one epoch and the test pool: no kernel runs, a finite
   loss, metrics in [0, 1], model.0.bin in the CNN_BERT layout;
   examples/s, peak memory.
19. graph-steps: k micro-steps per dispatch as CUDA graphs
   (medvill_torch/train/dispatch.py) against eager micro-steps.  K1-K4,
   each captured alone with a device seed, draw in a replay the mask of an
   eager launch from the same seed word (and the plain version's), another
   mask for another word, 0.9 +- 0.005 kept (bf16, L = 64 / R = 2048,
   the masks read back from the outputs).  Legs: finetune (the finetune
   CLI's defaults, fused_ln on, batch 4) and pretrain (the pretrain CLI's
   defaults: BAR, batch 36, accumulation 4), 8 micro-steps as two
   dispatches of 4; retrieval (140 rows) and classification (batch 56,
   the trunk trained), 4 micro-steps as two dispatches of 2.  Each from
   equal states and seeds at dropout 0 (finetune and pretrain also at the
   CLI's 0.1), both under PyTorch's deterministic algorithms: every
   parameter, buffer and stacked metric within 1e-3 of its tensor's scale
   of the eager run's (the worst printed; bitwise equal expected), the
   same kernel launches per micro-step; at dropout 0 also under PyTorch's
   default algorithms, as the CLIs run, where two eager runs differ: a
   second eager run measures that spread, and the graphed run's mean
   distance from the nearer (per tensor, over its scale) stays within 3 x
   the eager runs' mean distance, floored at 1e-2; then the steady ms per
   micro-step of each on one resident batch in turns (eager, graphed,
   graphed, eager) and, under torch.profiler, the device-busy ms and idle
   share.  Before
   the legs, the finetune CLI at --steps_per_dispatch 1, 4, 4, 1:
   reports/s, exactly 12/12/24/24 K1-K4 launches per micro-step, replays
   counted, peak memory; then two epochs at k = 4 across --drop_after
   (ratio 0, then 0.2: new graphs): the peak reserved within 1 GiB of a
   one-epoch k = 4 run's (the first ratio's graphs are let go).

20. resume: the pretrain CLI at its defaults (BERT-base, 180 random-pixel
   fibers at 512 px, L = 436, BAR, batch 36, accumulation 4) for 2 epochs
   of the train phase's 8 batches at --steps_per_dispatch 2, with
   --test_dataset (36 records), --watch_interval 1, --profile_dir and
   --log_freq 1, under PyTorch's deterministic algorithms: a real SIGTERM,
   sent when dispatch 1 of epoch 0 is logged, stops it after dispatch 2
   with 2 of 4 micro-batches accumulated (marker 0 / 6); the same argv
   relaunched consumes the marker, and its model.1.bin and optim.1.bin
   equal an uninterrupted run's bit for bit, its eval rows too; K1 runs
   12 times per eval batch; the eval loss on the final weights within
   train-parity's bf16 rules of the plain path (f32 the yardstick); the
   profile holds the attention kernels; K1 at the eval call checked
   against its plain version and timed; the sizes of the optim files, the
   seconds per save, the eval's ms per batch, the fresh and the relaunched
   run's seconds to their first dispatch.
21. resume-ft: the finetune CLI at its defaults with {"fused_ln": true}
   and --steps_per_dispatch 4 for 2 epochs: a SIGTERM as epoch 0's first
   group is handed out stops it after that dispatch (marker 0 / 4); the
   relaunch re-enters epoch 0 at batch 4 and ends bit-equal to an
   uninterrupted run; one more relaunch resumes by scan at epoch 2, past
   the last epoch.
22. preempt-clf: the classification CLI at its defaults (batch 56, the
   trunk trained): a SIGTERM as the first batch is handed out is read
   after that batch (within preempt.POLL_EVERY), model.0.bin is written
   and holds the in-memory weights.

23. tokenizer: make_tokenizer (what the four training CLIs call) returns
   the native wordpiece tokenizer (medvill_torch/data/native_tokenizer.py,
   built by g++ in the build phase) with its library loaded; its ids equal
   the Python tokenizer's on the 288 train reports, 32 of them upper-cased
   with punctuation and the fallback cases (non-ASCII, a literal special
   token, a NUL byte, an overflow of its buffer), with and without the
   unused-token remap; host ms to tokenize the reports each way, and the
   pretrain loader's host ms per batch of 36 (4 threads) with each, in
   turns python, native, native, python.
24. pretrain-vit: the ViT image encoder at full width (BERT-base, 512 px,
   patch 32: 256 image tokens, seq_len 253, L = 512, BAR, batch 36,
   accumulation 4): the pretrain CLI with --img_encoder ViT
   --num_image_embeds 256 over the train records (8 micro-steps), eagerly
   and at --steps_per_dispatch 4: finite losses, exactly 12 K1 and 12 K2
   per micro-step (replays counted), no warning logged, the native
   tokenizer in use, model.0.bin loading strictly with the patch
   embedding; pairs/s, ms per micro-step, peak memory.  K1/K2 at that call
   (B = 36, L = 512, BAR, img_block 258) against their plain versions in
   f32 and bf16 at rates 0 and 0.1, the skipped tile pairs read back and
   equal to the predicate, timed beside bound, plain and library; K3/K4 at
   R = 36 x 512 = 18432 the same way; then the trainer with fused_ln on:
   exactly 12/12/24/24 K1-K4 launches per micro-step, the loss falls, and
   the steady ms per micro-step eager against graphed (k = 4) in turns.
25. tp-heads: K1/K2 on the local heads of --model_parallel 2 and 4 (H 6
   and H 3 of BERT-base's 12) at the pretrain call (B = 36, L = 436, BAR)
   against their plain versions in f32 and bf16 at rates 0 and 0.1; at
   rate 0 the launches over each group of heads, concatenated, equal the
   H 12 launch bit for bit (o, lse, dq, dk, dv); timed at the training
   call (bf16, rate 0.1) beside bound, plain and library.
26. dist-1: the pretrain CLI at full width (B = 36, L = 436, BAR,
   fused_ln on) as a one-process launch (WORLD_SIZE=1, NCCL) with --zero1
   true, eagerly and at --steps_per_dispatch 4 (the gradient all-reduce,
   ZeRO-1's reduce-scatter and all-gather and the metrics' all-reduce
   captured in the CUDA graphs), against the same CLI without
   torch.distributed, under deterministic algorithms: the epoch's metrics
   and model.0.bin equal bit for bit, the optimizer state gathered from
   ZeRO-1's spans equal to the replicated one's, 12/12/24/24 K1-K4 per
   micro-step; then the steady ms per micro-step and peak memory of the
   step with and without the process group, eager and graphed (k = 4).
   Two ranks need two GPUs (NCCL refuses two ranks on one device): with
   one, a line says the two-rank legs wait for such a host.
27. dist-2 (two or more GPUs): two ranks of the pretrain CLI at full width
   (see phase_dist2): data parallelism with --zero1 true at k = 2, a
   SIGTERM to rank 1 alone stops both at one boundary and the relaunch
   ends bit-equal to an uninterrupted two-rank run, whose model.1.bin
   loads here and evaluates as rank 0 logged; each rank's peak memory
   lower with --zero1 true than without; --model_parallel 2 at dropout 0
   within 1e-3 of one process's losses.

Then the line of kernels (each with its launches by path and, beside the
training shape's figures, its figures at the finetune shape and the ViT
pretrain shape (``vit_shape``), K1/K2's at the classification and
retrieval shapes and on the tensor-parallel local heads (``tp_shape``),
K1's at the scoring and the eval calls), and last
{"ok": true, "device": {...}}.  Without
a CUDA device it prints the reason to stderr and exits 1.
"""
from __future__ import annotations

import base64
import dataclasses
import io
import json
import logging
import os
import random
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

from medvill_torch import parallel
from medvill_torch.checkpoint import recover_pretrain_into_vlp
from medvill_torch.cli import (classification_main, decode_main,
                               finetune_main, make_tokenizer, pretrain_main,
                               retrieval_main, serve_main)
from medvill_torch.config import (BertConfig, ImageEncoderConfig, MaskVariant,
                                  PretrainConfig)
from medvill_torch.convert import (load_cnn_bert_checkpoint,
                                   load_cxrbert_checkpoint,
                                   load_vlp_checkpoint)
from medvill_torch.data import images as image_lib
from medvill_torch.data import masks
from medvill_torch.data.classification import (ClassificationDataset,
                                               get_labels_and_frequencies,
                                               pos_weights,
                                               synthetic_clf_records)
from medvill_torch.data import native_tokenizer
from medvill_torch.data.pretrain import (BatchLoader, CXRPretrainDataset,
                                         collate)
from medvill_torch.data.retrieval import CXRRetrievalDataset, collate_pairs
from medvill_torch.data.seq2seq import Img2TxtDataset, Seq2seqPreprocessor
from medvill_torch.data.tokenization import BertTokenizer
from medvill_torch.data.vqa import VQADataset, synthetic_vqa_entries
from medvill_torch.models import bert as bert_lib
from medvill_torch.models import decoder
from medvill_torch.models.mmbt import full_spec
from medvill_torch.models.seq2seq import VLPForPreTraining, init_weights
from medvill_torch.ops import build
from medvill_torch.ops import flash_attention as fa
from medvill_torch.ops import fused_ln
from medvill_torch.ops.dropout import DropoutRNG
from medvill_torch.train import classify
from medvill_torch.train import finetune as finetune_lib
from medvill_torch.train import pretrain as pretrain_lib
from medvill_torch.train import retrieve as retrieve_lib
from medvill_torch.utils import preempt

# cuBLAS's deterministic workspace setting (8 x 4 MiB, PyTorch's default
# size on Hopper), read at the first GEMM: graph-steps compares under
# torch.use_deterministic_algorithms, which asks for it
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
HBM_BYTES_PER_S = 3.35e12      # H100 SXM (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12        # H100 SXM f32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 tensor cores
H = 768
BATCH, T_MAX, VIS, IMG = 8, 128, 256, 512
N_REQUESTS = 12
SEED = 0
# pretraining: PretrainConfig defaults (BERT-base, 180 of 256 fibers at
# 512 px, seq_len 253, batch 36, accumulation 4)
PRE_B, PRE_L, PRE_IMG_BLOCK = 36, 253 + 180 + 3, 182
HEADS, HEAD_DIM = 12, 64
FT_B, FT_L, FT_IMG_BLOCK = 4, 512, 258   # a finetune shape (seq2seq family)
# classification: the CLI's defaults (batch 56, 256 full-fiber embeds, text
# window 512 - 256), FULL spec over L = 258 + 256
CLF_B, CLF_N = 56, 256
CLF_IMG_BLOCK, CLF_L = CLF_N + 2, 512 + 2
CLF_TRAIN_BATCHES, CLF_IMAGES = 2, 8
CHEXPERT = ("Atelectasis", "Cardiomegaly", "Consolidation", "Edema",
            "Enlarged Cardiomediastinum", "Fracture", "Lung Lesion",
            "Lung Opacity", "No Finding", "Pleural Effusion", "Pleural Other",
            "Pneumonia", "Pneumothorax", "Support Devices")
# retrieval: the CLI's defaults (70 positive + 70 negative pairs = 140
# rows, 180 of 256 fibers, seq_len 253 so L = 436, FULL), scored at 70
RET_PAIRS, RET_B = 70, 140
RET_L, RET_IMG_BLOCK = PRE_L, PRE_IMG_BLOCK
RET_TRAIN_RECORDS = 2 * RET_PAIRS          # 2 micro-steps
# the pools: --eval_len_size candidates per query (the cut: the CLI's
# default is 759), 2 valid and 3 test queries
RET_POOL, RET_VALID_QUERIES, RET_TEST_QUERIES = 140, 2, 3
TRAIN_RECORDS, TRAIN_IMAGES = 288, 8
MICRO_STEPS = TRAIN_RECORDS // PRE_B
# finetuning: the finetune CLI's defaults over the first FT_RECORDS records
FT_RECORDS = 32
FT_MICRO_STEPS = FT_RECORDS // FT_B
# decoding: the decode CLI over the finetune records at batch BATCH, beam 4
BEAM = 4
DECODE_BATCHES = -(-FT_RECORDS // BATCH)
# the K4 instantiation of the training call (bf16, 3 chunks a lane at H 768)
K4_MAIN = "fused_ln_bwd_kernel<3>[bf16]"
# the ViT encoder at full width: patch 32 at 512 px gives 256 image tokens,
# seq_len 253, so L = 256 + 253 + 3 = 512 (BAR, batch 36)
VIT_N = (IMG // 32) ** 2
VIT_L, VIT_IMG_BLOCK = VIT_N + 253 + 3, VIT_N + 2


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def eager_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Per-call time of ``fn()`` issued from Python back to back, by CUDA
    events: includes the host's cost per call when that exceeds the
    device's (the serve path's situation)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 100, reps: int = 5,
              stream: torch.cuda.Stream = None) -> float:
    """Device time of one ``fn()``: ``iters`` calls captured in one CUDA
    graph and replayed, so the host's launch cost is out of the figure.
    ``fn`` may run autograd backward through a graph whose forward ran on
    ``stream`` (backward ops run on their forward's stream): the capture
    then happens on that stream."""
    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def bound(nbytes: float, nops: float, dtype) -> tuple:
    """(least ms, what bounds it): bytes over HBM rate vs operations over
    the peak rate of the dtype (bf16 tensor cores, f32 CUDA cores)."""
    peak = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else F32_FLOPS_PER_S
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = nops / peak * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def max_err(got: torch.Tensor, want: torch.Tensor, tol: float,
            what: str) -> float:
    err = (got.float() - want.float()).abs().max().item()
    check(err <= tol, f"{what}: max abs err {err} > {tol}")
    return err


def bf16_tol(want: torch.Tensor) -> float:
    """One bf16 ulp of the largest value: the LN kernels and their plain
    versions compute in f32 from the same inputs and round once.  (The
    attention kernels round between products: fa.bf16_tolerances.)"""
    return 2.0 ** -7 * want.float().abs().max().item()


def reset_counts() -> None:
    for fn in (fa.attn_fwd, fa.attn_bwd, fused_ln.fused_ln_fwd,
               fused_ln.fused_ln_bwd):
        fn.launches = 0


def read_counts() -> dict:
    return {"K1": fa.attn_fwd.launches, "K2": fa.attn_bwd.launches,
            "K3": fused_ln.fused_ln_fwd.launches,
            "K4": fused_ln.fused_ln_bwd.launches}


def phase_build() -> dict:
    """Builds both sources and, beside them, the native wordpiece library
    (g++); ptxas' registers and spills per kernel (none in the bf16
    attention kernels and in any K4 instantiation).  Returns the ptxas
    report."""
    t0 = time.perf_counter()
    wordpiece: dict = {}

    def build_wordpiece():
        t = time.perf_counter()
        wordpiece["path"] = native_tokenizer.build_library(force=True)
        wordpiece["seconds"] = time.perf_counter() - t

    g_plus = threading.Thread(target=build_wordpiece)
    g_plus.start()   # g++ beside the nvcc processes
    report = build.compile_all()
    g_plus.join()
    seconds = time.perf_counter() - t0
    check(wordpiece["path"] is not None,
          "the native wordpiece library did not build (g++)")
    ptxas = {name: build.ptxas_report(r["log"]) for name, r in report.items()}
    tc = {n: e for n, e in ptxas["flash_attention"].items()
          if "_tc_" in n}
    check(len(tc) == 3, f"ptxas report lacks the bf16 attention kernels: "
                        f"{sorted(ptxas['flash_attention'])}")
    k4 = {n: e for n, e in ptxas["fused_ln"].items()
          if n.startswith("fused_ln_bwd_kernel")}
    check(K4_MAIN in k4, f"ptxas report lacks {K4_MAIN}: "
                         f"{sorted(ptxas['fused_ln'])}")
    for n, e in {**tc, **k4}.items():
        check(e["spill_stores"] == e["spill_loads"] == 0, f"{n} spills: {e}")
    emit({"phase": "build", "seconds": seconds,
          "kernels": {n: r["seconds"] for n, r in report.items()},
          "wordpiece_seconds": wordpiece["seconds"], "ptxas": ptxas})
    return ptxas


def phase_kernel(device) -> dict:
    """Kernel vs plain at the serve and decode shapes; returns the bf16
    records by shape name."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    eps = 1e-5
    entries = {}
    for shape_name, rows in (("prefill", BATCH * (VIS + 2)),
                             ("window", BATCH * 2),
                             ("beam-window", BATCH * BEAM * 2)):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(rows, H, device=device, generator=gen).to(dtype)
            res = torch.randn(rows, H, device=device, generator=gen).to(dtype)
            gamma = torch.randn(H, device=device, generator=gen)
            beta = torch.randn(H, device=device, generator=gen)
            kw = dict(rate=0.0, eps=eps, seed=0)
            got = fused_ln.fused_dropout_add_ln(x, res, gamma, beta, **kw)
            torch.cuda.synchronize()
            want = fused_ln.fused_dropout_add_ln_plain(x, res, gamma, beta,
                                                       **kw)
            err = (got.float() - want.float()).abs().max().item()
            tol = 1e-5 if dtype == torch.float32 else \
                2.0 ** -7 * want.float().abs().max().item()
            check(err <= tol, f"fused_ln {shape_name} {dtype}: max abs err "
                              f"{err} > {tol}")
            g_lib, b_lib = gamma.to(dtype), beta.to(dtype)

            def kernel():
                fused_ln.fused_dropout_add_ln(x, res, gamma, beta, **kw)

            def plain():
                fused_ln.fused_dropout_add_ln_plain(x, res, gamma, beta,
                                                    **kw)

            def library():
                F.layer_norm(x + res, (H,), g_lib, b_lib, eps)

            kernel_ms, plain_ms, library_ms = (device_ms(f) for f in
                                               (kernel, plain, library))
            nbytes = 3 * rows * H * x.element_size() + 2 * H * 4
            nops = 10 * rows * H
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = nops / F32_FLOPS_PER_S * 1e3
            rec = {"phase": "kernel", "kernel": "fused_dropout_add_ln",
                   "shape": shape_name, "rows": rows, "h": H,
                   "dtype": str(dtype).replace("torch.", ""),
                   "max_abs_err": err, "tol": tol, "kernel_ms": kernel_ms,
                   "plain_ms": plain_ms, "library_ms": library_ms,
                   "kernel_eager_ms": eager_ms(kernel),
                   "library_eager_ms": eager_ms(library),
                   "bound_ms": max(bytes_ms, ops_ms),
                   "bound_by": "bytes" if bytes_ms >= ops_ms else
                   "operations"}
            emit(rec)
            if dtype == torch.bfloat16:
                entries[shape_name] = rec
    # dropout: with x = 1, res = 0, gamma = 1, beta = 0 a kept element
    # normalises above zero and a dropped one below, so y > 0 is the mask
    rows, rate, seed = BATCH * (VIS + 2), 0.1, 1234
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.ones(rows, H, device=device, dtype=dtype)
        res = torch.zeros(rows, H, device=device, dtype=dtype)
        one, zero = torch.ones(H, device=device), torch.zeros(H, device=device)
        y = fused_ln.fused_dropout_add_ln(x, res, one, zero, rate=rate,
                                          eps=eps, seed=seed)
        torch.cuda.synchronize()
        mask = fused_ln.keep_mask(seed, rows, H, rate, device)
        check(torch.equal(y > 0, mask), f"keep mask differs ({dtype})")
        frac = mask.float().mean().item()
        check(abs(frac - (1 - rate)) <= 0.005, f"keep fraction {frac}")
        xr = torch.randn(rows, H, device=device, generator=gen).to(dtype)
        got = fused_ln.fused_dropout_add_ln(xr, res, one, zero, rate=rate,
                                            eps=eps, seed=seed)
        want = fused_ln.fused_dropout_add_ln_plain(xr, res, one, zero,
                                                   rate=rate, eps=eps,
                                                   seed=seed)
        err = (got.float() - want.float()).abs().max().item()
        tol = 1e-5 if dtype == torch.float32 else \
            2.0 ** -7 * want.float().abs().max().item()
        check(err <= tol, f"fused_ln rate {rate} {dtype}: err {err} > {tol}")
        emit({"phase": "kernel-dropout", "dtype": str(dtype),
              "rate": rate, "mask_equal": True, "keep_fraction": frac,
              "max_abs_err": err})
    return entries


def write_vocab(path: str) -> None:
    """A synthetic 30522-token wordpiece vocabulary."""
    with open(path, "w") as f:
        for tok in ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]:
            f.write(tok + "\n")
        for i in range(30522 - 5):
            f.write(f"tok{i}\n")


def _write_fixture(d: str) -> list:
    """Vocab, config.json and a random full-width checkpoint; returns the
    serve CLI arguments."""
    vocab = os.path.join(d, "vocab.txt")
    write_vocab(vocab)
    cfg_path = os.path.join(d, "config.json")
    with open(cfg_path, "w") as f:
        json.dump({"fused_ln": True}, f)
    ckpt = os.path.join(d, "model.0.bin")
    argv = ["--vocab_file", vocab, "--model_recover_path", ckpt,
            "--config_path", cfg_path, "--device", "cuda",
            "--host", "127.0.0.1", "--port", "0",
            "--batch_size", str(BATCH), "--max_txt_length", str(T_MAX),
            "--len_vis_input", str(VIS), "--img_size", str(IMG)]
    cfg = serve_main.model_config(serve_main.build_parser().parse_args(argv))
    model = VLPForPreTraining(cfg.bert, cfg.image,
                              len_vis_input=cfg.len_vis_input)
    init_weights(model, SEED)
    torch.save(model.state_dict(), ckpt)
    return argv


def _png_b64(rng: np.random.Generator) -> str:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 255, (IMG, IMG), np.uint8),
                    "L").save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def phase_serve(argv: list) -> int:
    """Returns the fused kernel's launch count during the requests."""
    logger = logging.getLogger("chip_smoke")
    args = serve_main.build_parser().parse_args(argv)
    t0 = time.perf_counter()
    server = serve_main.make_server(args, logger)
    startup_s = time.perf_counter() - t0
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        host, port = server.server_address[:2]
        rng = np.random.default_rng(SEED)
        payloads = [json.dumps({"image_b64": _png_b64(rng)}).encode()
                    for _ in range(N_REQUESTS)]
        results = [None] * N_REQUESTS

        def call(i):
            req = urllib.request.Request(
                f"http://{host}:{port}/generate", data=payloads[i],
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=600) as r:
                results[i] = (r.status, json.loads(r.read()))

        stats = server.batcher.stats
        batches0 = stats["batches_total"]
        decode_s0 = stats["decode_seconds_total"]
        fused_ln.fused_ln_fwd.launches = 0
        t0 = time.perf_counter()
        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(N_REQUESTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t0
        launches = fused_ln.fused_ln_fwd.launches
        check(not any(t.is_alive() for t in threads), "a request hung")
        for i, r in enumerate(results):
            check(r is not None and r[0] == 200
                  and isinstance(r[1].get("caption"), str),
                  f"request {i}: {r}")
        batches = stats["batches_total"] - batches0
        decode_s = stats["decode_seconds_total"] - decode_s0
        per_batch = 2 * 12 * (1 + T_MAX)
        check(launches == per_batch * batches,
              f"fused_ln launches {launches} != {per_batch} * {batches}")
        emit({"phase": "serve", "requests": N_REQUESTS, "batches": batches,
              "padded_rows": stats["padded_rows_total"],
              "wall_s": wall, "reports_per_s": N_REQUESTS / wall,
              "tokens_per_s": N_REQUESTS * T_MAX / wall,
              "decode_s": decode_s,
              "decode_tokens_per_s": batches * BATCH * T_MAX / decode_s,
              "startup_s": startup_s,
              "warmup_s": server.warmup_seconds,
              "fused_ln_launches": launches,
              "caption_words": [len(r[1]["caption"].split())
                                for r in results[:3]]})
        return launches
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


def _first_window_logits(model, image, device) -> torch.Tensor:
    """Prefill plus the first decode window, as greedy_decode runs them."""
    s = decoder.DecodeSettings(max_txt_length=T_MAX, mask_word_id=4,
                               eos_id=3)
    vis = model.len_vis_input + 2
    L = vis + T_MAX + 1
    B = image.shape[0]
    caches = model.init_kv_caches(B, L, device)
    model.decode_prefill(
        image, decoder._sep_last_ids(2, 3, B, vis, device),
        torch.full((B, vis), s.img_type_id, device=device), caches,
        decoder._prefill_bias(vis, L, device))
    window = torch.tensor([[3, 4]] * B, device=device)
    types = torch.tensor([[s.img_type_id, s.txt_type_id]] * B, device=device)
    logits, _ = model.decode_step(
        window, decoder._window_positions(s, vis, 0, B, device), types,
        caches, vis - 1, decoder._window_bias(vis, 0, L, device))
    return logits


def phase_parity(argv: list, device) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    args = serve_main.build_parser().parse_args(argv)
    cfg = serve_main.model_config(args)
    image = torch.from_numpy(np.random.default_rng(SEED + 1).integers(
        0, 256, (2, IMG, IMG, 3), dtype=np.uint8))
    logits = {}
    for name, fused, dev in (("fused-card", True, device),
                             ("plain-card", False, device),
                             ("plain-cpu", False, torch.device("cpu"))):
        bert = dataclasses.replace(cfg.bert, compute_dtype="float32",
                                   fused_ln=fused)
        model = VLPForPreTraining(bert, cfg.image,
                                  len_vis_input=cfg.len_vis_input)
        load_vlp_checkpoint(model, args.model_recover_path)
        model = model.eval().to(dev)
        with torch.inference_mode():
            logits[name] = _first_window_logits(model, image.to(dev),
                                                dev).cpu()
        del model
    errs = {"fused_vs_plain_card": (logits["fused-card"]
                                    - logits["plain-card"]).abs().max().item(),
            "card_vs_cpu": (logits["plain-card"]
                            - logits["plain-cpu"]).abs().max().item()}
    for k, e in errs.items():
        check(e <= 1e-3, f"parity {k}: max abs err {e} > 1e-3")
    check(all(torch.isfinite(v).all() for v in logits.values()),
          "non-finite logits")
    emit({"phase": "parity", "dtype": "float32", "tf32": False,
          "logits_shape": list(logits["plain-cpu"].shape), **errs,
          "tol": 1e-3})


def _attn_inputs(device, gen, B, L, img_block, family, variant, dtype,
                 heads: int = HEADS):
    q, k, v, do = (torch.randn(B, L, heads, HEAD_DIM, device=device,
                               generator=gen).to(dtype) for _ in range(4))
    if family == fa.FAMILY_PRETRAIN:
        txt = torch.randint(1, L - img_block + 1, (B,), device=device,
                            generator=gen)
    else:  # n_tokens: CLS + image + SEP + at least one token
        txt = torch.randint(img_block + 1, L + 1, (B,), device=device,
                            generator=gen)
    spec = torch.stack([torch.full_like(txt, variant), txt], 1)
    return q, k, v, do, spec.to(torch.int32).contiguous()


def phase_kernel_attn(device) -> dict:
    """K1/K2 against their plain versions; returns the kernels-line entries
    (pretrain shape, bf16, BAR, dropout 0.1: the training path's call)."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    cases = ([("pretrain", PRE_B, PRE_L, PRE_IMG_BLOCK, fa.FAMILY_PRETRAIN,
               int(v)) for v in MaskVariant]
             + [("seq2seq", FT_B, FT_L, FT_IMG_BLOCK, fa.FAMILY_SEQ2SEQ, m)
                for m in range(3)])
    worst: dict = {}
    main_errs = None
    for shape, B, L, ib, family, variant in cases:
        for dtype in (torch.float32, torch.bfloat16):
            for rate in (0.0, 0.1):
                q, k, v, do, spec = _attn_inputs(device, gen, B, L, ib,
                                                 family, variant, dtype)
                kw = dict(img_block=ib, l_real=L, family=family, rate=rate,
                          seed=17 + variant)
                errs, tol = _attn_errs(
                    q, k, v, do, spec, kw,
                    f"{shape} variant {variant} {dtype} rate {rate}")
                _worst(worst, f"{shape}/{str(dtype)[6:]}/rate{rate}", errs,
                       tol)
                if (shape, variant, dtype, rate) == (
                        "pretrain", int(MaskVariant.BAR), torch.bfloat16, 0.1):
                    main_errs = errs
                del q, k, v, do
    # the rate-0.1 keep mask read back from K1 in both types: with q = k = 0
    # every cell of a FULL row with all text valid has p = 1/L, and V
    # one-hot over a window of 64 keys makes O[r, d] > 0 iff key c0 + d was
    # kept
    B, L, rate, seed = PRE_B, PRE_L, 0.1, 1234
    mask = fa.keep_mask(seed, B, HEADS, L, rate, device)
    spec = torch.tensor([[int(MaskVariant.FULL), L - PRE_IMG_BLOCK]] * B,
                        dtype=torch.int32, device=device)
    for dtype in (torch.float32, torch.bfloat16):
        z = torch.zeros(B, L, HEADS, HEAD_DIM, device=device, dtype=dtype)
        for c0 in range(0, L, HEAD_DIM):
            w = min(HEAD_DIM, L - c0)
            v = torch.zeros_like(z)
            v[:, c0:c0 + w, :, :w] = torch.eye(w, device=device,
                                               dtype=dtype)[:, None]
            o, _ = fa.attn_fwd(z, z, v, spec, img_block=PRE_IMG_BLOCK,
                               l_real=L, family=fa.FAMILY_PRETRAIN, rate=rate,
                               seed=seed)
            check(torch.equal((o[..., :w] > 0).permute(0, 2, 1, 3),
                              mask[..., c0:c0 + w]),
                  f"K1 {dtype} keep mask differs from the plain one at keys "
                  f"{c0}+")
    keep_fraction = mask.float().mean().item()
    check(abs(keep_fraction - (1 - rate)) <= 0.005,
          f"keep fraction {keep_fraction}")
    del z, v, o, mask
    yardstick = _attn_yardstick(device, gen)

    # times: the training call (bf16, BAR, dropout 0.1)
    dtype = torch.bfloat16
    q, k, v, do, spec = _attn_inputs(device, gen, PRE_B, PRE_L, PRE_IMG_BLOCK,
                                     fa.FAMILY_PRETRAIN, int(MaskVariant.BAR),
                                     dtype)
    kw = dict(img_block=PRE_IMG_BLOCK, l_real=PRE_L,
              family=fa.FAMILY_PRETRAIN, rate=0.1, seed=5)
    o, lse = fa.attn_fwd(q, k, v, spec, **kw)
    # K2 has one writer per output element: two calls agree bit for bit
    first, second = (fa.attn_bwd(q, k, v, o, do, lse, spec, **kw)
                     for _ in range(2))
    check(all(torch.equal(x, y) for x, y in zip(first, second)),
          "K2 differs between two calls")
    del first, second
    f32_in = [t.float() for t in (q, k, v, do)]
    o32, lse32 = fa.attn_fwd(*f32_in[:3], spec, **kw)

    def k1_f32():
        fa.attn_fwd(*f32_in[:3], spec, **kw)

    def k2_f32():
        fa.attn_bwd(*f32_in[:3], o32, f32_in[3], lse32, spec, **kw)

    # without dropout, as the library yardstick runs: the keep-mask hash's
    # share of the kernels' time
    kw0 = dict(kw, rate=0.0)

    def k1_rate0():
        fa.attn_fwd(q, k, v, spec, **kw0)

    def k2_rate0():
        fa.attn_bwd(q, k, v, o, do, lse, spec, **kw0)

    t = {**_attn_times(q, k, v, do, spec, kw),
         "k1_f32_ms": device_ms(k1_f32, iters=5, reps=2),
         "k2_f32_ms": device_ms(k2_f32, iters=3, reps=2),
         "k1_rate0_ms": device_ms(k1_rate0, iters=50, reps=3),
         "k2_rate0_ms": device_ms(k2_rate0, iters=20, reps=3)}
    del f32_in, o32, lse32
    pairs = t.pop("pairs")
    tflops = {"k1_tflops": 4 * pairs / t["k1_ms"] * 1e-9,
              "k2_tflops": 10 * pairs / t["k2_ms"] * 1e-9,
              "k1_library_tflops": 4 * pairs / t["k1_library_ms"] * 1e-9,
              "k2_library_tflops": 10 * pairs / t["k2_library_ms"] * 1e-9}
    # the pairs K1 and K2 skipped, read back from the kernels, against
    # Spec::skip's twin masks.tile_skippable
    want = masks.tile_skip_grid(fa.FAMILY_PRETRAIN, spec, PRE_IMG_BLOCK,
                                PRE_L, PRE_L, fa.TILE)[:, None].to(device)
    read = fa.skipped_tiles(q, k, v, do, spec, img_block=PRE_IMG_BLOCK,
                            l_real=PRE_L, family=fa.FAMILY_PRETRAIN)
    for name, got in read.items():
        check(torch.equal(got, want.expand_as(got)),
              f"{name} kernel skipped {int(got.sum())} tile pairs, the "
              f"predicate {int(want.sum()) * HEADS}")
    skipped_share = read["fwd"].float().mean().item()
    emit({"phase": "kernel-attn", "cases": len(cases) * 4,
          "max_abs_err": worst, "tol": {"f32": {"o": 1e-5, "lse": 1e-4,
                                                "grads": 1e-4},
                                        "bf16": "fa.bf16_tolerances; lse "
                                                "1e-4"},
          "keep_mask_equal": {"float32": True, "bfloat16": True},
          "keep_fraction": keep_fraction, "k2_deterministic": True,
          "yardstick": yardstick,
          "timed": "pretrain B=36 L=436 12x64 bf16 BAR rate 0.1", **t,
          **tflops, "skipped_tile_pairs": skipped_share,
          "skips_read_back_equal_predicate": True})
    del q, k, v, do, o, lse
    ft = _finetune_shape_attn(device, gen)
    mmbt = _mmbt_shape_attn(device, gen)
    retr = _retrieval_shape_attn(device, gen)
    k2_err = max(main_errs[n] for n in ("dq", "dk", "dv"))
    return {"K1": {"max_abs_err": main_errs["o"], "ms": t["k1_ms"],
                   "plain_ms": t["k1_plain_ms"], "bound_ms": t["k1_bound_ms"],
                   "bound_by": t["k1_bound_by"],
                   "library_ms": t["k1_library_ms"],
                   "tflops": tflops["k1_tflops"], "f32_ms": t["k1_f32_ms"],
                   "skipped_tile_pairs": skipped_share,
                   "finetune_shape": ft["K1"], "mmbt_shape": mmbt["K1"],
                   "retrieval_shape": retr["K1"],
                   "score_shape": retr["score"]},
            "K2": {"max_abs_err": k2_err, "ms": t["k2_ms"],
                   "plain_ms": t["k2_plain_ms"], "bound_ms": t["k2_bound_ms"],
                   "bound_by": t["k2_bound_by"],
                   "library_ms": t["k2_library_ms"],
                   "library_eager_ms": t["k2_library_eager_ms"],
                   "tflops": tflops["k2_tflops"], "f32_ms": t["k2_f32_ms"],
                   "skipped_tile_pairs": skipped_share,
                   "finetune_shape": ft["K2"], "mmbt_shape": mmbt["K2"],
                   "retrieval_shape": retr["K2"]}}


def _attn_errs(q, k, v, do, spec, kw: dict, what: str) -> tuple:
    """K1 and K2 against their plain versions on the same inputs: ({o,
    lse, dq, dk, dv: max abs err}, {o, dq, dk, dv: tolerance}).  f32: o
    1e-5, gradients 1e-4 (summation order); bf16: fa.bf16_tolerances; lse
    1e-4 in both."""
    o, lse = fa.attn_fwd(q, k, v, spec, **kw)
    grads = fa.attn_bwd(q, k, v, o, do, lse, spec, **kw)
    torch.cuda.synchronize()
    want_o, want_lse = fa.attn_fwd_plain(q, k, v, spec, **kw)
    want = dict(zip(("dq", "dk", "dv"), fa.attn_bwd_plain(
        q, k, v, o, do, lse, spec, **kw)))
    tol = ({"o": 1e-5, "dq": 1e-4, "dk": 1e-4, "dv": 1e-4}
           if q.dtype == torch.float32
           else fa.bf16_tolerances(q, k, v, o, do, lse, spec,
                                   {"o": want_o, **want}, **kw))
    errs = {"o": max_err(o, want_o, tol["o"], f"K1 o {what}"),
            "lse": max_err(lse, want_lse, 1e-4, f"K1 lse {what}")}
    for name, g in zip(("dq", "dk", "dv"), grads):
        errs[name] = max_err(g, want[name], tol[name], f"K2 {name} {what}")
    return errs, tol


def _worst(worst: dict, key: str, errs: dict, tol: dict) -> None:
    """Keeps under ``worst[key]`` each tensor's largest error and largest
    share of its tolerance."""
    acc = worst.setdefault(key, {})
    for name, e in errs.items():
        acc[name] = max(acc.get(name, 0.0), e)
        if name != "lse":
            acc[name + "/tol"] = max(acc.get(name + "/tol", 0.0),
                                     e / tol[name])


def _attn_times(q, k, v, do, spec, kw: dict, backward: bool = True) -> dict:
    """Device times (CUDA graphs) of K1 and K2 on bf16 [B, L, heads, 64]
    inputs, of their plain versions and of the library calls
    (F.scaled_dot_product_attention with the same -10000 bias at rate 0,
    autograd through it for K2, the backward captured on its forward's
    stream); eager per-call times; the bounds, from the cells the masks
    leave visible (``pairs``: visible cells x heads x 64, the operations'
    unit; ``visible_cells``: their share of B x L x L).  Without
    ``backward``, K1's figures only."""
    B, L, heads = q.shape[:3]
    o, lse = fa.attn_fwd(q, k, v, spec, **kw)

    def k1():
        fa.attn_fwd(q, k, v, spec, **kw)

    def k2():
        fa.attn_bwd(q, k, v, o, do, lse, spec, **kw)

    def k1_plain():
        fa.attn_fwd_plain(q, k, v, spec, **kw)

    def k2_plain():
        fa.attn_bwd_plain(q, k, v, o, do, lse, spec, **kw)

    bias = fa.score_bias(spec, L, kw["img_block"], L,
                         kw["family"]).to(q.dtype)
    ql, kl, vl = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    do_l = do.transpose(1, 2).contiguous()
    lib_stream = torch.cuda.Stream()
    lib_stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(lib_stream):
        out = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=bias)

    def k1_library():
        with torch.no_grad():
            F.scaled_dot_product_attention(ql, kl, vl, attn_mask=bias)

    def k2_library():
        torch.autograd.grad(out, (ql, kl, vl), do_l, retain_graph=True)

    # the work this call's masks leave: the visible (query, key) cells, and
    # the k and v rows some query sees (a key no query sees is never read)
    vis = bias[:, 0] == 0
    row = heads * HEAD_DIM * q.element_size()
    pairs = int(vis.sum()) * heads * HEAD_DIM
    full, seen = B * L * row, int(vis.any(1).sum()) * row
    lse_bytes = B * heads * L * 4
    # K1 reads q, k, v and writes o, lse; K2 reads q, k, v, o, dO, lse and
    # writes dq, dk, dv
    k1_bound, k1_by = bound(2 * full + 2 * seen + lse_bytes, 4 * pairs,
                            q.dtype)
    k2_bound, k2_by = bound(6 * full + 2 * seen + lse_bytes, 10 * pairs,
                            q.dtype)
    fwd = {"pairs": pairs, "visible_cells": pairs / (B * L * L * heads
                                                      * HEAD_DIM),
           "k1_ms": device_ms(k1, iters=50, reps=3),
           "k1_plain_ms": device_ms(k1_plain, iters=3, reps=2),
           "k1_library_ms": device_ms(k1_library, iters=50, reps=3),
           "k1_eager_ms": eager_ms(k1, iters=20, warmup=3),
           "k1_bound_ms": k1_bound, "k1_bound_by": k1_by}
    if not backward:
        return fwd
    return {**fwd, "k2_ms": device_ms(k2, iters=20, reps=3),
            "k2_plain_ms": device_ms(k2_plain, iters=3, reps=2),
            "k2_library_ms": device_ms(k2_library, iters=20, reps=3,
                                       stream=lib_stream),
            "k2_library_eager_ms": eager_ms(k2_library, iters=10, warmup=2),
            "k2_eager_ms": eager_ms(k2, iters=10, warmup=2),
            "k2_bound_ms": k2_bound, "k2_bound_by": k2_by}


def _finetune_shape_attn(device, gen) -> dict:
    """K1/K2 at the finetune step's call (B = 4, L = 512, img_block 258,
    s2s, bf16, rate 0.1) against their plain versions (fa.bf16_tolerances)
    and timed (_attn_times); returns the kernels-line entries."""
    q, k, v, do, spec = _attn_inputs(device, gen, FT_B, FT_L, FT_IMG_BLOCK,
                                     fa.FAMILY_SEQ2SEQ, 1, torch.bfloat16)
    kw = dict(img_block=FT_IMG_BLOCK, l_real=FT_L, family=fa.FAMILY_SEQ2SEQ,
              rate=0.1, seed=6)
    errs, _ = _attn_errs(q, k, v, do, spec, kw, "finetune shape")
    o_err = errs["o"]
    g_err = max(errs[n] for n in ("dq", "dk", "dv"))
    t = _attn_times(q, k, v, do, spec, kw)
    emit({"phase": "kernel-attn", "timed": "finetune B=4 L=512 12x64 bf16 "
                                           "s2s rate 0.1", **t,
          "max_abs_err": {"o": o_err, "grads": g_err}})
    return {kid: {"max_abs_err": err, "ms": t[f"{n}_ms"],
                  "plain_ms": t[f"{n}_plain_ms"],
                  "bound_ms": t[f"{n}_bound_ms"],
                  "bound_by": t[f"{n}_bound_by"],
                  "library_ms": t[f"{n}_library_ms"]}
            for kid, n, err in (("K1", "k1", o_err), ("K2", "k2", g_err))}


def _mmbt_shape_attn(device, gen) -> dict:
    """K1/K2 at the classification step's call (B = 56, L = 258 + 256 =
    514, FULL, img_block 258, pretrain family: the last tile holds 2 rows
    and the key tiles of the text padding are skipped) against their plain
    versions in f32 and bf16 at rates 0 and 0.1 (_attn_errs); the skipped
    tile pairs read back from the kernels and equal to the predicate; times
    of the training call (bf16, rate 0.1; _attn_times).  Returns the
    kernels-line entries."""
    worst: dict = {}
    for dtype in (torch.float32, torch.bfloat16):
        for rate in (0.0, 0.1):
            q, k, v, do, spec = _attn_inputs(
                device, gen, CLF_B, CLF_L, CLF_IMG_BLOCK, fa.FAMILY_PRETRAIN,
                int(MaskVariant.FULL), dtype)
            kw = dict(img_block=CLF_IMG_BLOCK, l_real=CLF_L,
                      family=fa.FAMILY_PRETRAIN, rate=rate, seed=8)
            errs, tol = _attn_errs(q, k, v, do, spec, kw,
                                   f"mmbt shape {dtype} rate {rate}")
            _worst(worst, f"{str(dtype)[6:]}/rate{rate}", errs, tol)
            del q, k, v, do
    q, k, v, do, spec = _attn_inputs(device, gen, CLF_B, CLF_L, CLF_IMG_BLOCK,
                                     fa.FAMILY_PRETRAIN,
                                     int(MaskVariant.FULL), torch.bfloat16)
    kw = dict(img_block=CLF_IMG_BLOCK, l_real=CLF_L,
              family=fa.FAMILY_PRETRAIN, rate=0.1, seed=9)
    errs, _ = _attn_errs(q, k, v, do, spec, kw, "mmbt shape timed call")
    want = masks.tile_skip_grid(fa.FAMILY_PRETRAIN, spec, CLF_IMG_BLOCK,
                                CLF_L, CLF_L, fa.TILE)[:, None].to(device)
    read = fa.skipped_tiles(q, k, v, do, spec, img_block=CLF_IMG_BLOCK,
                            l_real=CLF_L, family=fa.FAMILY_PRETRAIN)
    for name, got in read.items():
        check(torch.equal(got, want.expand_as(got)),
              f"mmbt shape: {name} kernel skipped {int(got.sum())} tile "
              f"pairs, the predicate {int(want.sum()) * HEADS}")
    skipped = read["fwd"].float().mean().item()
    t = _attn_times(q, k, v, do, spec, kw)
    emit({"phase": "kernel-attn", "timed": f"mmbt B={CLF_B} L={CLF_L} 12x64 "
                                           "bf16 FULL rate 0.1", **t,
          "cases": 4, "max_abs_err": worst, "skipped_tile_pairs": skipped,
          "skips_read_back_equal_predicate": True})
    g_err = max(errs[n] for n in ("dq", "dk", "dv"))
    return {kid: {"max_abs_err": err, "ms": t[f"{n}_ms"],
                  "plain_ms": t[f"{n}_plain_ms"],
                  "bound_ms": t[f"{n}_bound_ms"],
                  "bound_by": t[f"{n}_bound_by"],
                  "library_ms": t[f"{n}_library_ms"],
                  "skipped_tile_pairs": skipped}
            for kid, n, err in (("K1", "k1", errs["o"]),
                                ("K2", "k2", g_err))}


def _retrieval_inputs(device, gen, B, dtype, rng: np.random.Generator):
    """q, k, v, dO at the retrieval call and its FULL spec, text lengths
    uniform in 1..254 from the numpy ``rng``."""
    q, k, v, do, _ = _attn_inputs(device, gen, B, RET_L, RET_IMG_BLOCK,
                                  fa.FAMILY_PRETRAIN, int(MaskVariant.FULL),
                                  dtype)
    txt = rng.integers(1, RET_L - RET_IMG_BLOCK + 1, B)
    spec = torch.tensor(np.stack([np.zeros_like(txt), txt], 1),
                        dtype=torch.int32, device=device)
    return q, k, v, do, spec


def _retrieval_shape_attn(device, gen) -> dict:
    """K1/K2 at the retrieval training call (B = 140: 70 positives and 70
    negatives; L = 436, FULL, img_block 182, text lengths uniform in
    1..254 from a seeded numpy draw) against their plain versions in f32
    and bf16 at rates 0 and 0.1 (_attn_errs); the skipped tile pairs read
    back and equal to the predicate; times of the training call (bf16,
    rate 0.1; _attn_times); then K1 at the scoring call (B = 70, rate 0,
    bf16): against its plain version and timed beside its bound, its plain
    version and the library.  Returns the kernels-line entries."""
    rng = np.random.default_rng(SEED + 8)
    worst: dict = {}
    for dtype in (torch.float32, torch.bfloat16):
        for rate in (0.0, 0.1):
            q, k, v, do, spec = _retrieval_inputs(device, gen, RET_B, dtype,
                                                  rng)
            kw = dict(img_block=RET_IMG_BLOCK, l_real=RET_L,
                      family=fa.FAMILY_PRETRAIN, rate=rate, seed=10)
            errs, tol = _attn_errs(q, k, v, do, spec, kw,
                                   f"retrieval shape {dtype} rate {rate}")
            _worst(worst, f"{str(dtype)[6:]}/rate{rate}", errs, tol)
            del q, k, v, do
    q, k, v, do, spec = _retrieval_inputs(device, gen, RET_B, torch.bfloat16,
                                          rng)
    kw = dict(img_block=RET_IMG_BLOCK, l_real=RET_L,
              family=fa.FAMILY_PRETRAIN, rate=0.1, seed=11)
    errs, _ = _attn_errs(q, k, v, do, spec, kw, "retrieval timed call")
    want = masks.tile_skip_grid(fa.FAMILY_PRETRAIN, spec, RET_IMG_BLOCK,
                                RET_L, RET_L, fa.TILE)[:, None].to(device)
    read = fa.skipped_tiles(q, k, v, do, spec, img_block=RET_IMG_BLOCK,
                            l_real=RET_L, family=fa.FAMILY_PRETRAIN)
    for name, got in read.items():
        check(torch.equal(got, want.expand_as(got)),
              f"retrieval shape: {name} kernel skipped {int(got.sum())} "
              f"tile pairs, the predicate {int(want.sum()) * HEADS}")
    skipped = read["fwd"].float().mean().item()
    t = _attn_times(q, k, v, do, spec, kw)
    del q, k, v, do
    # the scoring call: K1 alone, rate 0, on 70 candidates
    q, k, v, do, sspec = _retrieval_inputs(device, gen, RET_PAIRS,
                                           torch.bfloat16, rng)
    skw = dict(img_block=RET_IMG_BLOCK, l_real=RET_L,
               family=fa.FAMILY_PRETRAIN, rate=0.0, seed=0)
    score_err = _attn_errs(q, k, v, do, sspec, skw, "scoring call")[0]["o"]
    st = _attn_times(q, k, v, do, sspec, skw, backward=False)
    emit({"phase": "kernel-attn",
          "timed": f"retrieval B={RET_B} L={RET_L} 12x64 bf16 FULL rate 0.1",
          **t, "cases": 4, "max_abs_err": worst, "skipped_tile_pairs": skipped,
          "skips_read_back_equal_predicate": True,
          "score_call": {"timed": f"B={RET_PAIRS} bf16 FULL rate 0",
                         "max_abs_err": score_err, **st}})
    g_err = max(errs[n] for n in ("dq", "dk", "dv"))
    out = {kid: {"max_abs_err": err, "ms": t[f"{n}_ms"],
                 "plain_ms": t[f"{n}_plain_ms"],
                 "bound_ms": t[f"{n}_bound_ms"],
                 "bound_by": t[f"{n}_bound_by"],
                 "library_ms": t[f"{n}_library_ms"],
                 "skipped_tile_pairs": skipped}
           for kid, n, err in (("K1", "k1", errs["o"]), ("K2", "k2", g_err))}
    out["score"] = {"max_abs_err": score_err, "ms": st["k1_ms"],
                    "plain_ms": st["k1_plain_ms"],
                    "bound_ms": st["k1_bound_ms"],
                    "bound_by": st["k1_bound_by"],
                    "library_ms": st["k1_library_ms"]}
    return out


def _attn_yardstick(device, gen) -> dict:
    """K1/K2 in bf16 against the library at the training shape (BAR, rate
    0): both held to the plain version on f32 copies of the same bf16
    inputs; the kernel's error, largest and root mean square, may be at
    most twice F.scaled_dot_product_attention's (autograd for the
    backward), tensor by tensor."""
    q, k, v, do, spec = _attn_inputs(device, gen, PRE_B, PRE_L, PRE_IMG_BLOCK,
                                     fa.FAMILY_PRETRAIN, int(MaskVariant.BAR),
                                     torch.bfloat16)
    kw = dict(img_block=PRE_IMG_BLOCK, l_real=PRE_L,
              family=fa.FAMILY_PRETRAIN, rate=0.0, seed=0)
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    ref_o, ref_lse = fa.attn_fwd_plain(qf, kf, vf, spec, **kw)
    ref = dict(zip(("o", "dq", "dk", "dv"), (ref_o, *fa.attn_bwd_plain(
        qf, kf, vf, ref_o, dof, ref_lse, spec, **kw))))
    del qf, kf, vf, dof, ref_lse
    o, lse = fa.attn_fwd(q, k, v, spec, **kw)
    kernel = dict(zip(("o", "dq", "dk", "dv"),
                      (o, *fa.attn_bwd(q, k, v, o, do, lse, spec, **kw))))
    bias = fa.score_bias(spec, PRE_L, PRE_IMG_BLOCK, PRE_L,
                         fa.FAMILY_PRETRAIN).to(torch.bfloat16)
    ql, kl, vl = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    out = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=bias)
    grads = torch.autograd.grad(out, (ql, kl, vl),
                                do.transpose(1, 2).contiguous())
    library = dict(zip(("o", "dq", "dk", "dv"),
                       (t.detach().transpose(1, 2) for t in (out, *grads))))
    torch.cuda.synchronize()
    # the largest error is mostly the output's own bf16 rounding, alike on
    # both sides; the root mean square shows the rounding inside
    errs = {}
    for name, want in ref.items():
        errs[name] = {}
        for src, got in (("kernel", kernel), ("library", library)):
            d = got[name].float() - want
            errs[name][src] = {"max": d.abs().max().item(),
                               "rms": d.square().mean().sqrt().item()}
        for stat in ("max", "rms"):
            mine, lib = (errs[name][s][stat] for s in ("kernel", "library"))
            check(mine <= 2 * lib, f"yardstick {name} {stat}: kernel error "
                                   f"{mine} > 2 x the library's {lib}")
    return errs


def _k4_errs(x, res, gamma, beta, dy, kw: dict, what: str) -> dict:
    """K4 once against its plain version and against autograd through the
    plain forward: dx, dres f32 1e-5 (1e-4 against autograd), bf16 one ulp;
    dgamma/dbeta sum over the rows in another order, 1e-6 per row and at
    least 16 rows' worth (one row's dy * xhat reaches ~16, where the two
    sides' rstd, 1/sqrtf against rsqrt, differ by a few f32 ulps).  dx is
    zero where the forward dropped x."""
    rows = x.numel() // x.shape[-1]
    f32 = x.dtype == torch.float32
    got = fused_ln.fused_ln_bwd(x, res, gamma, dy, **kw)
    torch.cuda.synchronize()
    want = fused_ln.fused_dropout_add_ln_bwd_plain(x, res, gamma, dy, **kw)
    leaves = [t.detach().clone().requires_grad_()
              for t in (x, res, gamma, beta)]
    auto = torch.autograd.grad(
        fused_ln.fused_dropout_add_ln_plain(*leaves, **kw), leaves, dy)
    errs = {}
    for i, name in enumerate(("dx", "dres", "dgamma", "dbeta")):
        tol = (1e-6 * max(rows, 16) if i >= 2 else
               1e-5 if f32 else bf16_tol(want[i]))
        errs[name] = max_err(got[i], want[i], tol, f"K4 {name} {what}")
        errs[name + "_vs_autograd"] = max_err(
            got[i], auto[i], tol if i >= 2 or not f32 else 1e-4,
            f"K4 {name} vs autograd {what}")
    if kw["rate"] > 0:
        keep = fused_ln.keep_mask(kw["seed"], rows, x.shape[-1], kw["rate"],
                                  x.device)
        check(bool((got[0][~keep] == 0).all()),
              f"K4 dx is not zero where x was dropped ({what})")
    return errs


def _ln_inputs(device, gen, rows: int, h: int, dtype) -> tuple:
    x, res, dy = (torch.randn(rows, h, device=device, generator=gen).to(dtype)
                  for _ in range(3))
    gamma, beta = (torch.randn(h, device=device, generator=gen)
                   for _ in range(2))
    return x, res, gamma, beta, dy


def phase_kernel_ln_bwd(device, ptxas: dict) -> dict:
    """K4 (and K3 at dropout 0.1) at the training shape; K4 also at the
    edges of its persistent grid; both at the finetune step's call.  Returns
    the kernels-line entries (bf16, dropout 0.1)."""
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    rows = PRE_B * PRE_L
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        f32 = dtype == torch.float32
        for rate in (0.0, 0.1):
            x, res, gamma, beta, dy = _ln_inputs(device, gen, rows, H, dtype)
            kw = dict(rate=rate, eps=1e-12, seed=77)
            what = f"{dtype} rate {rate}"
            errs = _k4_errs(x, res, gamma, beta, dy, kw, what)
            y = fused_ln.fused_ln_fwd(x, res, gamma, beta, **kw)
            y_want = fused_ln.fused_dropout_add_ln_plain(x, res, gamma, beta,
                                                         **kw)
            errs["k3_y"] = max_err(y, y_want, 1e-5 if f32 else
                                   bf16_tol(y_want), f"K3 {what}")
            rec = {"phase": "kernel-ln-bwd", "rows": rows, "h": H,
                   "dtype": str(dtype)[6:], "rate": rate, "max_abs_err": errs}
            if dtype == torch.bfloat16 and rate > 0:
                # dgamma/dbeta are summed in a fixed order: two calls agree
                # bit for bit
                first, second = (fused_ln.fused_ln_bwd(x, res, gamma, dy,
                                                       **kw)
                                 for _ in range(2))
                check(all(torch.equal(a, b) for a, b in zip(first, second)),
                      "K4 differs between two calls")
                del first, second
                per_sm, warps, sms = fused_ln.bwd_residency(device.index, H,
                                                            True)
                k4_build = {"registers": ptxas["fused_ln"][K4_MAIN][
                    "registers"], "blocks_per_sm": per_sm,
                    "warps_per_block": warps, "sms": sms,
                    "grid": fused_ln.bwd_grid(device.index, H, True, rows)}
                t = _ln_times(x, res, gamma, beta, dy, kw)
                rec.update(t, k4_deterministic=True, k4=k4_build)
                out = {"K3": {"max_abs_err": errs["k3_y"], "ms": t["k3_ms"],
                              "plain_ms": t["k3_plain_ms"],
                              "bound_ms": t["k3_bound_ms"],
                              "bound_by": t["k3_bound_by"],
                              "library_ms": t["k3_library_ms"]},
                       "K4": {"max_abs_err": max(errs["dx"], errs["dres"]),
                              "ms": t["k4_ms"], "plain_ms": t["k4_plain_ms"],
                              "bound_ms": t["k4_bound_ms"],
                              "bound_by": t["k4_bound_by"],
                              "library_ms": t["k4_library_ms"],
                              "library_eager_ms": t["k4_library_eager_ms"],
                              **k4_build}}
            emit(rec)
    # K4's grid edges: one row, a row count no block share divides, the
    # widest bf16 row and the f32 test width
    edges = {}
    for n, h, dtype in ((1, H, torch.bfloat16), (rows + 1, H, torch.bfloat16),
                        (rows + 1, 1024, torch.bfloat16),
                        (1, 32, torch.float32), (rows + 1, 32, torch.float32)):
        what = f"{n}x{h} {str(dtype)[6:]}"
        edges[what] = _k4_errs(*_ln_inputs(device, gen, n, h, dtype),
                               dict(rate=0.1, eps=1e-12, seed=78), what)
    emit({"phase": "kernel-ln-bwd", "rate": 0.1, "edges": edges})
    # the finetune step's call: R = 4 * 512, LN eps 1e-5
    rows = FT_B * FT_L
    x, res, gamma, beta, dy = _ln_inputs(device, gen, rows, H,
                                         torch.bfloat16)
    kw = dict(rate=0.1, eps=1e-5, seed=79)
    errs = _k4_errs(x, res, gamma, beta, dy, kw, "finetune shape")
    y_want = fused_ln.fused_dropout_add_ln_plain(x, res, gamma, beta, **kw)
    errs["k3_y"] = max_err(fused_ln.fused_ln_fwd(x, res, gamma, beta, **kw),
                           y_want, bf16_tol(y_want), "K3 finetune shape")
    t = _ln_times(x, res, gamma, beta, dy, kw)
    emit({"phase": "kernel-ln-bwd", "rows": rows, "h": H, "dtype": "bfloat16",
          "rate": 0.1, "timed": "finetune R=2048", "max_abs_err": errs, **t})
    for kid, n, err in (("K3", "k3", errs["k3_y"]),
                        ("K4", "k4", max(errs["dx"], errs["dres"]))):
        out[kid]["finetune_shape"] = {
            "max_abs_err": err, "ms": t[f"{n}_ms"],
            "plain_ms": t[f"{n}_plain_ms"], "bound_ms": t[f"{n}_bound_ms"],
            "bound_by": t[f"{n}_bound_by"],
            "library_ms": t[f"{n}_library_ms"]}
    return out


def _ln_times(x, res, gamma, beta, dy, kw: dict) -> dict:
    """Device times (CUDA graphs) of K4 and K3 on [R, H] inputs, of their
    plain versions and of the library calls (autograd through
    F.layer_norm(x + res) for K4, captured on its forward's stream;
    F.layer_norm(x + res) for K3); eager per-call times of K4 and its
    library call; the bounds: K4 reads x, res, dy, gamma and writes dx,
    dres, dgamma, dbeta, K3 reads x, res, gamma, beta and writes y."""
    rows, h = x.shape
    dtype = x.dtype

    def k4():
        fused_ln.fused_ln_bwd(x, res, gamma, dy, **kw)

    def k4_plain():
        fused_ln.fused_dropout_add_ln_bwd_plain(x, res, gamma, dy, **kw)

    def k3():
        fused_ln.fused_ln_fwd(x, res, gamma, beta, **kw)

    def k3_plain():
        fused_ln.fused_dropout_add_ln_plain(x, res, gamma, beta, **kw)

    lx, lr_, lg, lb = (t.detach().clone().requires_grad_()
                       for t in (x, res, gamma.to(dtype), beta.to(dtype)))
    lib_stream = torch.cuda.Stream()
    lib_stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(lib_stream):
        ly = F.layer_norm(lx + lr_, (h,), lg, lb, kw["eps"])

    def k4_library():
        torch.autograd.grad(ly, (lx, lr_, lg, lb), dy, retain_graph=True)

    def k3_library():
        F.layer_norm(x + res, (h,), lg.detach(), lb.detach(), kw["eps"])

    k4_bound, k4_by = bound(5 * rows * h * 2 + 3 * h * 4, 20 * rows * h,
                            dtype)
    k3_bound, k3_by = bound(3 * rows * h * 2 + 2 * h * 4, 10 * rows * h,
                            dtype)
    return {"k4_ms": device_ms(k4, iters=50, reps=3),
            "k4_plain_ms": device_ms(k4_plain, iters=10, reps=2),
            "k4_library_ms": device_ms(k4_library, iters=50, reps=3,
                                       stream=lib_stream),
            "k4_library_eager_ms": eager_ms(k4_library, iters=50, warmup=5),
            "k4_eager_ms": eager_ms(k4, iters=50, warmup=5),
            "k3_ms": device_ms(k3, iters=50, reps=3),
            "k3_plain_ms": device_ms(k3_plain, iters=10, reps=2),
            "k3_library_ms": device_ms(k3_library, iters=50, reps=3),
            "k4_bound_ms": k4_bound, "k4_bound_by": k4_by,
            "k3_bound_ms": k3_bound, "k3_bound_by": k3_by}


def write_train_data(d: str, vocab: str) -> str:
    """TRAIN_RECORDS JSONL records over TRAIN_IMAGES shared 512-px PNGs,
    each report 240 words of the synthetic vocabulary (240 of the 253 text
    positions after tokenization)."""
    from PIL import Image

    rng = np.random.default_rng(SEED + 2)
    for j in range(TRAIN_IMAGES):
        Image.fromarray(rng.integers(0, 255, (IMG, IMG), np.uint8),
                        "L").save(os.path.join(d, f"img{j}.png"),
                                  format="PNG")
    with open(vocab) as f:
        words = [w.strip() for w in f][5:]
    path = os.path.join(d, "train.jsonl")
    with open(path, "w") as f:
        for i in range(TRAIN_RECORDS):
            text = " ".join(words[j] for j in rng.integers(0, len(words), 240))
            f.write(json.dumps({"id": str(i), "split": "train",
                                "label": f"label{i % 5}", "text": text,
                                "img": f"img{i % TRAIN_IMAGES}.png"}) + "\n")
    return path


def phase_train(d: str, vocab: str) -> tuple:
    """The pretrain CLI's entry point at the full configuration; returns
    (launch counts, the training data path)."""
    data = write_train_data(d, vocab)
    out = os.path.join(d, "pretrain_run")
    argv = ["--train_dataset", data, "--vocab_file", vocab,
            "--output_path", out, "--epochs", "1", "--device", "cuda",
            "--log_freq", "4", "--num_workers", "4"]
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    rows = pretrain_main.main(argv)
    wall = time.perf_counter() - t0
    counts = read_counts()
    row = rows[0]
    check(row["micro_steps"] == MICRO_STEPS, f"micro steps {row}")
    check(all(np.isfinite(row[k]) for k in ("avg_loss", "avg_mlm_loss",
                                             "avg_itm_loss")),
          f"non-finite losses {row}")
    check(os.path.getsize(os.path.join(out, "model.0.bin")) > 1e8,
          "no checkpoint written")
    want = {"K1": 12 * MICRO_STEPS, "K2": 12 * MICRO_STEPS, "K3": 0, "K4": 0}
    check(counts == want, f"train launches {counts} != {want}")
    emit({"phase": "train", "records": TRAIN_RECORDS,
          "micro_steps": MICRO_STEPS, "batch": PRE_B, "seq": PRE_L,
          "pairs_per_s": row["pairs_per_s"],
          "ms_per_micro_step": row["epoch_time_s"] / MICRO_STEPS * 1e3,
          "epoch_s": row["epoch_time_s"], "wall_s": wall,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "avg_loss": row["avg_loss"], "avg_mlm_loss": row["avg_mlm_loss"],
          "avg_itm_loss": row["avg_itm_loss"], "launches": counts,
          "launches_per_micro_step": {k: v / MICRO_STEPS
                                      for k, v in counts.items()}})
    return counts, data


def _train_batch(data: str, vocab: str, cfg, device, batch_size: int):
    tok = BertTokenizer.from_vocab_file(vocab, remap_unused=False)
    loader = BatchLoader(CXRPretrainDataset(data, tok, cfg, seed=SEED),
                         batch_size, shuffle=False)
    return pretrain_lib.to_device(next(iter(loader)), device)


def _steady_ms(state, step, batch, steps: int = 4) -> float:
    """Host-clock ms per micro-step of ``step(state, batch, generator)``
    after two of warmup, ending in a sync."""
    gen = torch.Generator().manual_seed(SEED)
    for _ in range(2):
        step(state, batch, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step(state, batch, gen)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3


def phase_train_fused(data: str, vocab: str, device) -> dict:
    """fused_ln on through the trainer: 4 micro-steps on one repeated batch
    (accumulation 1, so each step updates), each from a generator with the
    same seed, so every step draws the same pixels and dropout masks and
    the loss moves only with the parameters; returns the launch counts.
    Then steady-state ms per micro-step, fused LN on and off, at the CLI's
    accumulation of 4."""
    bert = dataclasses.replace(BertConfig(), fused_ln=True)
    cfg = PretrainConfig(bert=bert, image=ImageEncoderConfig(),
                         batch_size=PRE_B, gradient_accumulation_steps=1)
    batch = _train_batch(data, vocab, cfg, device, PRE_B)
    state = pretrain_lib.init_state(cfg, seed=SEED, device=device)
    step = pretrain_lib.make_train_step(cfg)
    reset_counts()
    losses = [step(state, batch, torch.Generator().manual_seed(SEED))
              ["loss"].item() for _ in range(4)]
    counts = read_counts()
    del state
    want = {"K1": 12 * 4, "K2": 12 * 4, "K3": 24 * 4, "K4": 24 * 4}
    check(counts == want, f"train-fused launches {counts} != {want}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"train-fused loss did not fall: {losses}")
    timing = {}
    for fused in (True, False):
        c = dataclasses.replace(
            cfg, bert=dataclasses.replace(bert, fused_ln=fused),
            gradient_accumulation_steps=4)
        timing["fused" if fused else "unfused"] = _steady_ms(
            pretrain_lib.init_state(c, seed=SEED, device=device),
            pretrain_lib.make_train_step(c), batch)
    emit({"phase": "train-fused", "losses": losses, "launches": counts,
          "launches_per_micro_step": {k: v / 4 for k, v in counts.items()},
          "steady_ms_per_micro_step": timing,
          "steady_pairs_per_s": {k: PRE_B / v * 1e3
                                 for k, v in timing.items()}})
    return counts


KERNEL_COUNTS = {"K1": 12, "K2": 12, "K3": 24, "K4": 24}


def _plain_attention(spec, img_block: int, family: int, rate: float):
    """The attention kernels' plain version behind the ``attention_fn`` hook,
    drawing its seed from the rng as make_attention_fn does."""

    def fn(q, k, v, bias, rng=None, deterministic=True):
        r = 0.0 if deterministic else rate
        seed = rng.next_seed() if r > 0 else 0
        return fa.attn_fwd_plain(q, k, v, spec, img_block=img_block,
                                 l_real=q.shape[1], family=family, rate=r,
                                 seed=seed)[0]

    return fn


def _kernel_and_plain(model, loss_fn, plain_attention, what: str) -> dict:
    """One step's loss and gradients by the kernel path (K1-K4, once each
    per layer) and by the plain path (the plain versions swapped in), from
    the same weights and BatchNorm statistics.  ``loss_fn(attention_fn)``
    runs the forward, with None for the kernels, and returns the loss or
    (the loss, its terms: the per-position and per-example losses it is
    the mean of).  Returns {path: (loss, {name: grad}, terms or None)}."""
    buffers = {k: v.clone() for k, v in model.named_buffers()}
    out = {}
    kernel_ln = bert_lib.fused_dropout_add_ln
    for path in ("kernel", "plain"):
        model.zero_grad(set_to_none=True)
        with torch.no_grad():
            for k, v in model.named_buffers():
                v.copy_(buffers[k])
        reset_counts()
        try:
            if path == "plain":
                bert_lib.fused_dropout_add_ln = \
                    fused_ln.fused_dropout_add_ln_plain
            loss = loss_fn(plain_attention if path == "plain" else None)
            terms = None
            if isinstance(loss, tuple):
                loss, terms = loss
            loss.backward()
        finally:
            bert_lib.fused_dropout_add_ln = kernel_ln
        counts = read_counts()
        check((counts == KERNEL_COUNTS) if path == "kernel"
              else not any(counts.values()),
              f"{what} {path} path launches {counts}")
        out[path] = (loss.item(), {n: p.grad.detach().float().clone()
                                   for n, p in model.named_parameters()
                                   if p.grad is not None}, terms)
    return out


def _loss_terms(model, batch: dict, per_position):
    """A context that records a training forward's loss terms: each call of
    ``per_position`` (a module attribute (module, name) returning per-term
    losses, or the pretrain MLM's ``_mlm_ce``, whose valid labels' NLLs are
    recorded) and, where the model has an ITM head, each example's ITM
    cross-entropy.  The terms are listed in ``terms`` (f32, on the
    device)."""
    import contextlib

    module, name = per_position
    real = getattr(module, name)
    terms: list = []

    def recorded(logits, labels, *a, **kw):
        out = real(logits, labels, *a, **kw)
        if name == "_mlm_ce":
            valid = labels != -100
            gold = torch.gather(logits, -1, torch.where(valid, labels, 0)
                                .unsqueeze(-1)).squeeze(-1)
            terms.append((torch.logsumexp(logits, -1) - gold)[valid]
                         .detach().float())
        else:
            terms.append(out[batch["masked_weights"] > 0].detach().float())
        return out

    @contextlib.contextmanager
    def ctx():
        setattr(module, name, recorded)
        itm = getattr(model, "itm_logits", None)
        if itm is not None:
            def itm_logits(pooled):
                out = itm(pooled)
                logits = out.detach().float()
                labels = batch["is_aligned"].long()
                terms.append(torch.logsumexp(logits, -1) - torch.gather(
                    logits, -1, labels.unsqueeze(-1)).squeeze(-1))
                return out
            model.itm_logits = itm_logits
        try:
            yield terms
        finally:
            setattr(module, name, real)
            if itm is not None:
                del model.itm_logits

    return ctx()


def _parity_step(data, vocab, device, compute_dtype: str) -> dict:
    """One pretraining step at full width, batch 4, fused_ln on, dropout
    0.1, in ``compute_dtype``, by both paths (_kernel_and_plain) from the
    same weights, batch, pixels and dropout seeds."""
    bert = dataclasses.replace(BertConfig(), compute_dtype=compute_dtype,
                               fused_ln=True)
    cfg = PretrainConfig(bert=bert, image=ImageEncoderConfig(),
                         batch_size=4, gradient_accumulation_steps=1)
    batch = _train_batch(data, vocab, cfg, device, 4)
    model = pretrain_lib.build_model(cfg)
    init_weights(model, SEED)
    model.to(device)
    pix = pretrain_lib.sample_pixel_indices(
        torch.Generator().manual_seed(SEED), cfg.image.num_fibers,
        cfg.image.num_image_embeds).to(device)

    def loss_fn(attention_fn):
        with _loss_terms(model, batch, (pretrain_lib, "_mlm_ce")) as terms:
            loss = pretrain_lib.pretrain_loss_and_metrics(
                model, batch, DropoutRNG(SEED + 3, device), pix, cfg,
                train=True, attention_fn=attention_fn)[0]
        return loss, torch.cat(terms)

    return _kernel_and_plain(
        model, loss_fn, _plain_attention(
            batch["mask_spec"], PRE_IMG_BLOCK, fa.FAMILY_PRETRAIN,
            bert.attention_probs_dropout_prob), f"train {compute_dtype}")


def _compare_grads(got: dict, want: dict) -> tuple:
    """(worst tensor, its max abs err over its scale, key-bias figures).
    A tensor's scale is its largest entry in ``want``; a key bias's exact
    gradient is 0 (softmax ignores a shift shared by a row), so both sides
    give rounding noise there, and its scale is the largest entry of its
    layer's key-weight gradient."""
    check(got.keys() == want.keys(), "gradient sets differ")
    top = {n: w.abs().max().item() for n, w in want.items()}
    worst_name, worst = "", 0.0
    key_bias = {"max_abs_err": 0.0, "plain_max": 0.0, "kernel_max": 0.0}
    for name, w in want.items():
        err = (got[name] - w).abs().max().item()
        scale = top[name]
        if name.endswith("attention.self.key.bias"):
            scale = top[name[:-len("bias")] + "weight"]
            key_bias["max_abs_err"] = max(key_bias["max_abs_err"], err)
            key_bias["plain_max"] = max(key_bias["plain_max"], top[name])
            key_bias["kernel_max"] = max(key_bias["kernel_max"],
                                         got[name].abs().max().item())
        if err / scale > worst:
            worst_name, worst = name, err / scale
    return worst_name, worst, key_bias


def _check_parity_legs(legs: dict, rec: dict, phase: str) -> None:
    """The kernel path against the plain path in two legs (see
    _kernel_and_plain).  f32 (TF32 off): the loss within 1e-4 relative and
    every gradient within 1e-3 of its scale.  bf16: the kernels round P and
    dS to bf16 between products and K3/K4 round their outputs, where the
    plain path computes attention and LN in f32 and rounds once; every
    other operation is the same bf16 arithmetic on both paths.  So the
    kernel path may move the step by about what bf16 compute itself moves
    it, measured here as the plain path's distance in bf16 from the same
    step in f32: the loss within twice that of the plain path, and each
    gradient tensor's largest distance within twice the plain path's for
    that tensor.  Where ``loss_fn`` gives the loss's terms (the
    per-position and per-example losses it is the mean of) the loss is held
    twice: (1) the root mean square of the kernel path's distance from the
    plain path, term by term, within twice that of the plain path's bf16
    terms from its f32 ones; (2) the loss itself, within twice the plain
    path's relative bf16-vs-f32 distance, that limit floored at three
    standard errors of the plain path's bf16 mean (3 x the terms' rms
    distance / sqrt(terms), relative to the loss).  The mean's own
    distance is one sample of the rounding, and the terms' errors can
    cancel in it (finetune-parity's plain bf16 mean sat 3.4e-6 from f32 on
    an H100 where its terms sat ~1e-3 apart): the floor keeps such a
    sample from deciding alone, and (2) still bounds a shift of every
    term.  Key biases are left out of the per-tensor test: their exact
    gradient is 0 (see _compare_grads), so both distances are rounding
    noise.  ``legs`` may hold the f32 leg alone.  Fills ``rec``."""
    def rms(a, b) -> float:
        return (a - b).square().mean().sqrt().item()

    # the plain path's own bf16-vs-f32 distance, the bf16 leg's yardstick
    f_loss, f_grads, f_terms = legs["float32"]["plain"]
    if "bfloat16" in legs:
        b_loss, b_grads, b_terms = legs["bfloat16"]["plain"]
        floor_name, floor, _ = _compare_grads(b_grads, f_grads)
        floor_loss = abs(b_loss - f_loss) / abs(f_loss)
        floor_terms = None if f_terms is None else rms(b_terms, f_terms)
        std_err = (None if f_terms is None
                   else floor_terms / b_terms.numel() ** 0.5)
    for dt, paths in legs.items():
        (k_loss, k_grads, k_terms), (p_loss, p_grads, p_terms) = (
            paths["kernel"], paths["plain"])
        rel = abs(k_loss - p_loss) / abs(p_loss)
        worst_name, worst, key_bias = _compare_grads(k_grads, p_grads)
        rec[dt] = {"losses": {"kernel": k_loss, "plain": p_loss},
                   "loss_rel_err": rel, "grads": len(p_grads),
                   "worst_grad_rel_err": worst, "worst_grad": worst_name,
                   "key_bias": key_bias, "tol": {}}
        check(np.isfinite(k_loss), f"{phase} {dt} loss {k_loss}")
        loss_tol = 1e-4 if dt == "float32" else 2.0 * floor_loss
        if dt != "float32" and std_err is not None:
            se_floor = 3.0 * std_err / abs(p_loss)
            rec[dt]["tol"].update(loss_rel_from_mean=loss_tol,
                                  loss_rel_std_err_floor=se_floor)
            loss_tol = max(loss_tol, se_floor)
        check(rel <= loss_tol, f"{phase} {dt} loss {k_loss} vs {p_loss} "
                               f"(relative {rel} > {loss_tol})")
        rec[dt]["tol"]["loss_rel"] = loss_tol
        if dt != "float32" and floor_terms is not None:
            dist = rms(k_terms, p_terms)
            check(dist <= 2.0 * floor_terms,
                  f"{phase} bf16 loss terms: rms distance {dist} > 2 x the "
                  f"plain path's bf16-vs-f32 {floor_terms}")
            rec[dt].update({"loss_terms": int(p_terms.numel()),
                            "loss_terms_rms_dist": dist})
            rec[dt]["tol"]["loss_terms_rms_dist"] = 2.0 * floor_terms
        if dt == "float32":
            check(worst <= 1e-3, f"{phase} f32 gradient {worst_name}: "
                                 f"{worst} of its scale > 1e-3")
            rec[dt]["tol"]["grad_rel_to_max"] = 1e-3
            continue
        ratios = {n: (k_grads[n] - w).abs().max().item()
                  / max((w - f_grads[n]).abs().max().item(), 1e-30)
                  for n, w in p_grads.items()
                  if not n.endswith("attention.self.key.bias")}
        ratio_name = max(ratios, key=ratios.get)
        check(ratios[ratio_name] <= 2.0,
              f"{phase} bf16 gradient {ratio_name}: "
              f"{ratios[ratio_name]} x the plain path's bf16-vs-f32 distance")
        rec[dt].update({"largest_kernel_over_bf16_ratio": ratios[ratio_name],
                        "largest_ratio_grad": ratio_name})
        rec[dt]["tol"]["kernel_over_bf16_ratio"] = 2.0
        rec[dt]["plain_bf16_vs_f32"] = {
            "loss_rel_err": floor_loss, "loss_terms_rms_dist": floor_terms,
            "loss_std_err": std_err, "worst_grad_rel_err": floor,
            "worst_grad": floor_name}


def phase_train_parity(data: str, vocab: str, device) -> None:
    """One pretraining step, kernel path against plain path, in an f32 and
    a bf16 leg (_check_parity_legs)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    legs = {dt: _parity_step(data, vocab, device, dt)
            for dt in ("float32", "bfloat16")}
    rec = {"phase": "train-parity", "tf32": False, "batch": 4,
           "dropout": 0.1, "fused_ln": True}
    _check_parity_legs(legs, rec, "train-parity")
    emit(rec)


def _finetune_argv(d: str, vocab: str, data: str) -> list:
    """The finetune CLI's arguments: its defaults, fused_ln on, the train
    phase's pretrain checkpoint, one epoch over the first FT_RECORDS
    records."""
    ft_data = os.path.join(d, "finetune.jsonl")
    with open(data) as f, open(ft_data, "w") as g:
        g.writelines(line for _, line in zip(range(FT_RECORDS), f))
    return ["--src_file", ft_data, "--vocab_file", vocab,
            "--output_dir", os.path.join(d, "finetune_run"),
            "--model_recover_path",
            os.path.join(d, "pretrain_run", "model.0.bin"),
            "--config_path", os.path.join(d, "config.json"),
            "--max_pred", "128", "--num_train_epochs", "1",
            "--device", "cuda"]


def phase_finetune(argv: list, device) -> dict:
    """The finetune CLI's entry point; returns the launch counts."""
    args = finetune_main.build_parser().parse_args(argv)
    cfg = finetune_main.config_from_args(args)
    # the recover the CLI runs, on a model of its own: token types 2 -> 6
    model = finetune_lib.build_model(cfg)
    loaded, missing = recover_pretrain_into_vlp(model,
                                                args.model_recover_path)
    types = model.txt_embeddings.token_type_embeddings.weight.detach()
    pre = torch.load(args.model_recover_path, map_location="cpu",
                     weights_only=True)[
                         "enc.txt_embeddings.token_type_embeddings.weight"]
    check(not missing and types.shape[0] == 6
          and torch.equal(types, pre[[0, 1, 0, 0, 0, 1]]),
          f"recover: missing {missing}, token types {types.shape}")
    del model
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    result = finetune_main.main(argv)
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    row = result["epochs"][0]
    check(row["micro_steps"] == FT_MICRO_STEPS, f"micro steps {row}")
    check(all(np.isfinite(row[k]) for k in ("loss", "masked_lm_loss")),
          f"non-finite losses {row}")
    want = {k: v * FT_MICRO_STEPS for k, v in KERNEL_COUNTS.items()}
    check(counts == want, f"finetune launches {counts} != {want}")
    ckpt = os.path.join(args.output_dir, "model.0.bin")
    model = VLPForPreTraining(cfg.bert, cfg.image,
                              len_vis_input=cfg.len_vis_input)
    check(load_vlp_checkpoint(model, ckpt) == [], "unused checkpoint keys")
    model = model.prepare_for_compute().eval().to(device)
    image = torch.from_numpy(np.random.default_rng(SEED + 4).integers(
        0, 256, (2, IMG, IMG, 3), dtype=np.uint8)).to(device)
    settings = decoder.DecodeSettings(max_txt_length=16, mask_word_id=4,
                                      eos_id=3)
    with torch.inference_mode():
        ids, logp, _ = decoder.greedy_decode(model, image, settings, 2, 3)
    check(ids.shape == (2, 16) and bool(torch.isfinite(logp).all()),
          f"decode from the finetuned checkpoint: {ids.shape}")
    del model
    emit({"phase": "finetune", "records": FT_RECORDS,
          "micro_steps": FT_MICRO_STEPS, "batch": FT_B, "seq": FT_L,
          "max_pred": cfg.max_pred, "recovered_tensors": len(loaded),
          "reports_per_s": FT_MICRO_STEPS * FT_B / row["epoch_time_s"],
          "ms_per_micro_step": row["epoch_time_s"] / FT_MICRO_STEPS * 1e3,
          "epoch_s": row["epoch_time_s"], "wall_s": wall,
          "peak_mem_gib": peak, "loss": row["loss"], "launches": counts,
          "launches_per_micro_step": {k: v / FT_MICRO_STEPS
                                      for k, v in counts.items()},
          "decode_mean_logprob": logp.mean().item()})
    return counts


def _finetune_batch(cfg, vocab: str, device):
    """The first FT_B records of the finetune data as one batch."""
    tok = BertTokenizer.from_vocab_file(vocab, remap_unused=True)
    loader = BatchLoader(Img2TxtDataset(cfg.src_file, tok, cfg, seed=SEED),
                         FT_B, shuffle=False)
    return pretrain_lib.to_device(next(iter(loader)), device)


def phase_finetune_steps(argv: list, device) -> None:
    """Report generation through medvill_torch.train.finetune on one
    repeated batch, each micro-step from a generator of the same seed (the
    same dropout), lr 1e-4, t_total 4: the first update has lr 0, so the
    second loss equals the first; the loss then falls.  2 VQA micro-steps
    and the VQA eval; the steady ms per micro-step with fused_ln on and
    off at the CLI's configuration."""
    args = finetune_main.build_parser().parse_args(
        argv + ["--learning_rate", "1e-4"])
    cfg = finetune_main.config_from_args(args)
    batch = _finetune_batch(cfg, args.vocab_file, device)
    state = finetune_lib.init_state(cfg, t_total=4, seed=SEED, device=device)
    step = finetune_lib.make_train_step(cfg)
    losses = [step(state, batch, torch.Generator().manual_seed(SEED))
              ["loss"].item() for _ in range(5)]
    del state
    check(all(np.isfinite(losses)), f"finetune-steps losses {losses}")
    check(abs(losses[1] - losses[0]) <= 1e-6 * abs(losses[0]),
          f"the first update (lr 0) moved the loss: {losses}")
    check(losses[-1] < losses[0], f"finetune-steps loss did not fall: "
                                  f"{losses}")
    # VQA: synthetic questions over the same images, 458 answers
    vqa_cfg = dataclasses.replace(cfg, task="vqa", s2s_prob=0.5, bi_prob=0.5)
    entries = synthetic_vqa_entries(3 * FT_B, vqa_cfg.vqa_num_answers,
                                    seed=SEED)
    for i, e in enumerate(entries):
        e["image_name"] = f"img{i % TRAIN_IMAGES}.png"
    tok = BertTokenizer.from_vocab_file(args.vocab_file, remap_unused=True)
    root = os.path.dirname(cfg.src_file)
    train = BatchLoader(VQADataset(vqa_cfg, tok, entries[:2 * FT_B],
                                   image_root=root, seed=SEED), FT_B,
                        shuffle=False)
    test = BatchLoader(VQADataset(vqa_cfg, tok, entries[2 * FT_B:],
                                  image_root=root, seed=SEED), FT_B,
                       shuffle=False, drop_last=False)
    state = finetune_lib.init_state(vqa_cfg, t_total=2, seed=SEED,
                                    device=device)
    vqa_step = finetune_lib.make_train_step(vqa_cfg)
    gen = torch.Generator().manual_seed(SEED)
    reset_counts()
    vqa_losses = [vqa_step(state, pretrain_lib.to_device(
        {k: b[k] for k in ("image", "input_ids", "segment_ids", "mask_spec",
                           "ans_target")}, device), gen)["loss"].item()
        for b in train]
    vqa_counts = read_counts()
    acc = finetune_lib.vqa_evaluate(finetune_lib.make_vqa_eval_step(vqa_cfg),
                                    state, test)
    del state
    check(len(vqa_losses) == 2 and all(np.isfinite(vqa_losses)),
          f"VQA losses {vqa_losses}")
    check(vqa_counts == {k: 2 * v for k, v in KERNEL_COUNTS.items()},
          f"VQA launches {vqa_counts}")
    check(np.isfinite(acc["vqa_acc"]) and all(
        np.isfinite(acc[k + "_acc"]) for k in ("closed", "open")
        if acc["n_" + k]), f"VQA eval {acc}")
    timing = {}
    for fused in (True, False):
        c = dataclasses.replace(cfg, bert=dataclasses.replace(
            cfg.bert, fused_ln=fused))
        timing["fused" if fused else "unfused"] = _steady_ms(
            finetune_lib.init_state(c, t_total=100, seed=SEED,
                                    device=device),
            finetune_lib.make_train_step(c), batch)
    emit({"phase": "finetune-steps", "losses": losses, "lr": cfg.lr,
          "vqa_losses": vqa_losses, "vqa_launches": vqa_counts,
          "vqa_eval": acc, "steady_ms_per_micro_step": timing,
          "steady_reports_per_s": {k: FT_B / v * 1e3
                                   for k, v in timing.items()}})


def _finetune_parity_step(cfg, vocab: str, device,
                          compute_dtype: str) -> dict:
    """One report-generation step at full width, batch 4 (rows s2s, s2s,
    bi, bar), fused_ln on, dropout 0.1, in ``compute_dtype``, by both paths
    (_kernel_and_plain)."""
    cfg = dataclasses.replace(cfg, bert=dataclasses.replace(
        cfg.bert, compute_dtype=compute_dtype, fused_ln=True))
    ds = Img2TxtDataset(cfg.src_file, BertTokenizer.from_vocab_file(
        vocab, remap_unused=True), cfg)
    rows = []
    for i, (mode, bar) in enumerate((("s2s", False), ("s2s", False),
                                     ("bi", False), ("s2s", True))):
        rec = ds.data[i]
        row = Seq2seqPreprocessor(cfg, ds.tokenizer, mode, bar=bar)(
            ds.tokenizer.tokenize(rec["text"]), rng=random.Random(i))
        row["image"] = image_lib.as_wire_image(ds.image_loader(rec["img"]))
        rows.append(row)
    batch = pretrain_lib.to_device(collate(rows), device)
    check(batch["mask_spec"][:, 0].tolist() == [1, 1, 0, 2],
          f"parity modes {batch['mask_spec'].tolist()}")
    model = finetune_lib.build_model(cfg)
    init_weights(model, SEED)
    model.to(device)

    def loss_fn(attention_fn):
        with _loss_terms(model, batch, (finetune_lib,
                                        "label_smoothing_loss")) as terms:
            loss = finetune_lib.finetune_loss_and_metrics(
                model, batch, DropoutRNG(SEED + 3, device), cfg,
                attention_fn=attention_fn)[0]
        return loss, torch.cat(terms)

    return _kernel_and_plain(
        model, loss_fn, _plain_attention(
            batch["mask_spec"], cfg.len_vis_input + 2, fa.FAMILY_SEQ2SEQ,
            cfg.bert.attention_probs_dropout_prob),
        f"finetune {compute_dtype}")


def phase_finetune_parity(argv: list, device) -> None:
    """train-parity's legs and tolerances on one finetune step."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    args = finetune_main.build_parser().parse_args(argv)
    cfg = finetune_main.config_from_args(args)
    legs = {dt: _finetune_parity_step(cfg, args.vocab_file, device, dt)
            for dt in ("float32", "bfloat16")}
    rec = {"phase": "finetune-parity", "tf32": False, "batch": FT_B,
           "modes": ["s2s", "s2s", "bi", "bar"], "dropout": 0.1,
           "fused_ln": True}
    _check_parity_legs(legs, rec, "finetune-parity")
    emit(rec)


def _decode_argv(ft_argv: list, d: str, *extra) -> list:
    """The decode CLI's arguments: its defaults at batch BATCH and
    T_MAX tokens, fused_ln on, the finetune phase's model.0.bin, the
    finetune records."""
    args = finetune_main.build_parser().parse_args(ft_argv)
    return ["--src_file", args.src_file, "--vocab_file", args.vocab_file,
            "--model_recover_path",
            os.path.join(args.output_dir, "model.0.bin"),
            "--config_path", args.config_path,
            "--batch_size", str(BATCH), "--max_txt_length", str(T_MAX),
            "--device", "cuda", *extra]


def _beam_leg(argv: list, image, device, compute_dtype: str) -> dict:
    """beam_search on one batch with fused_ln on (K3) and off (plain), in
    ``compute_dtype``: {"fused": (ids, scores), "plain": ..., "model": the
    fused model, "settings": ...}.  The finetune phase's model, a few steps
    on reports of random words, puts [SEP] first and leaves the other
    logits nearly flat, so f32 summation noise reorders its top-K: the legs
    replace its (tied) word embeddings by unit-scale draws from SEED, as
    tests/torch_port_support.py does, so the vocabulary projection decides,
    and forbid EOS for the first half of the steps, so they compare long
    hypotheses."""
    args = decode_main.build_parser().parse_args(argv)
    cfg = decode_main.model_config(args)
    settings = decoder.DecodeSettings(
        max_txt_length=T_MAX, mask_word_id=4, eos_id=3, beam_size=BEAM,
        forbid_duplicate_ngrams=True, min_len=T_MAX // 2)
    out = {}
    for name, fused in (("fused", True), ("plain", False)):
        bert = dataclasses.replace(cfg.bert, compute_dtype=compute_dtype,
                                   fused_ln=fused)
        model = VLPForPreTraining(bert, cfg.image,
                                  len_vis_input=cfg.len_vis_input)
        load_vlp_checkpoint(model, args.model_recover_path)
        with torch.no_grad():
            emb = model.txt_embeddings.word_embeddings.weight
            emb.copy_(torch.randn(emb.shape, generator=torch.Generator()
                                  .manual_seed(SEED)))
        model = model.prepare_for_compute().eval().to(device)
        with torch.inference_mode():
            out[name] = decoder.beam_search(model, image, settings, 2, 3)
        if fused:
            out["model"], out["settings"] = model, settings
        else:
            del model
    return out


def _lengths(ids: torch.Tensor, eos_id: int) -> torch.Tensor:
    """Tokens of each row up to and including its first EOS (all T
    without one)."""
    eos = (ids == eos_id).int()
    return torch.where(eos.any(1), eos.argmax(1) + 1, ids.shape[1])


def _rescore(model, image, settings, ids: torch.Tensor) -> torch.Tensor:
    """Each row's log-probs up to its first EOS (or all T), teacher-forced
    in the beam's own geometry: the image prefilled at batch B, its caches
    repeated to B*K rows, every window step at B*K rows with each row's
    tokens in its K copies, the log-probs added step by step in f32 as the
    beam adds them.  [B, K], one column per copy.  At other row counts the
    card's f32 GEMMs reduce in another order, so each log-prob moves by a
    few ulp of the logits and a sum of 128 of them by about the 1e-3
    limit (reported as ``rescore_abs_err_batch_b``, not gated)."""
    K, T = settings.beam_size, settings.max_txt_length
    device, B = image.device, image.shape[0]
    vis = model.len_vis_input + 2
    L = vis + T + 1
    BK = B * K
    rows = ids.repeat_interleave(K, 0)
    live = (torch.arange(T, device=device)[None]
            < _lengths(rows, settings.eos_id)[:, None])
    with torch.inference_mode():
        caches = [(k.repeat_interleave(K, 0), v.repeat_interleave(K, 0))
                  for k, v in decoder._prefill(model, image, settings, 2, 3,
                                               L)]
        positions, types = decoder._window_inputs(settings, vis, T, device)
        mask_col = torch.full((BK,), settings.mask_word_id, dtype=torch.long,
                              device=device)
        committed = torch.full((BK,), 3, dtype=torch.long, device=device)
        score = torch.zeros(BK, device=device)
        for t in range(T):
            logits, caches = model.decode_step(
                torch.stack([committed, mask_col], dim=1),
                positions[t].expand(BK, 2), types[t].expand(BK, 2), caches,
                vis - 1 + t, decoder._window_bias(vis, t, L, device))
            logp = torch.log_softmax(logits.float(), dim=-1)
            committed = rows[:, t]
            score = torch.where(live[:, t], score + logp.gather(
                1, committed[:, None])[:, 0], score)
    return score.view(B, K)


def _rescore_batch_b(model, image, settings, ids: torch.Tensor
                     ) -> torch.Tensor:
    """The same sums from teacher-forced greedy decode at batch B."""
    with torch.inference_mode():
        _, _, nll = decoder.greedy_decode(model, image, settings, 2, 3,
                                          gt_tokens=ids,
                                          teacher_forcing=True)
    steps = torch.arange(ids.shape[1], device=ids.device)[None]
    return -(nll * (steps < _lengths(ids, settings.eos_id)[:, None])).sum(1)


def phase_decode(ft_argv: list, d: str, device) -> dict:
    """The decode CLI at full width: greedy (ppl, BLEU) and beam 4 with
    n-gram forbidding over the finetune records, each with exactly
    24 * (1 + T_MAX) K3 launches per batch; then beam search with fused_ln
    on against off on one batch, f32 (equal ids, scores within 1e-4
    relative, each score within 1e-3 of its teacher-forced rescoring in
    the beam's geometry, _rescore) and
    bf16 (rows that agree, finite scores), EOS forbidden for the first
    T_MAX / 2 steps (_beam_leg).  Returns the K3 launches of the two CLI
    runs."""
    runs, total = {}, 0
    for name, extra in (("greedy", ()),
                        ("beam4", ("--beam_size", str(BEAM),
                                   "--forbid_duplicate_ngrams", "true"))):
        out = os.path.join(d, f"decode_{name}")
        argv = _decode_argv(ft_argv, d, "--output_dir", out, *extra)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        (result,) = decode_main.main(argv)
        wall = time.perf_counter() - t0
        counts = read_counts()
        want = {"K1": 0, "K2": 0, "K3": 24 * (1 + T_MAX) * DECODE_BATCHES,
                "K4": 0}
        check(counts == want, f"decode {name} launches {counts} != {want}")
        total += counts["K3"]
        run = result["run_name"]
        with open(os.path.join(out, f"{run}_predictions.json")) as f:
            preds = json.load(f)
        check(len(preds) == FT_RECORDS and all(
            isinstance(p["caption"], str) for p in preds),
            f"decode {name}: {len(preds)} predictions")
        for f in (f"{run}.csv", f"{run}_gt.csv", "all_results.json"):
            check(os.path.isfile(os.path.join(out, f)), f"no {f}")
        check(all(np.isfinite(result[k]) for k in
                  ("Bleu_1", "Bleu_4", "decode_s")), f"decode {result}")
        if name == "greedy":
            check(np.isfinite(result["ppl"]), f"ppl {result}")
        runs[name] = {
            "run_name": run, "batches": DECODE_BATCHES,
            "decode_s": result["decode_s"],
            "decode_tokens_per_s": result["decode_tokens_per_s"],
            "wall_s": wall, "bleu": [result[f"Bleu_{n}"] for n in range(1, 5)],
            "ppl": result.get("ppl"),
            "empty_captions": sum(not p["caption"] for p in preds),
            "caption_words": [len(p["caption"].split()) for p in preds[:4]],
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "fused_ln_launches": counts["K3"]}
    argv = _decode_argv(ft_argv, d)
    image = torch.from_numpy(np.random.default_rng(SEED + 5).integers(
        0, 256, (BATCH, IMG, IMG, 3), dtype=np.uint8)).to(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    legs = {}
    f32 = _beam_leg(argv, image, device, "float32")
    (ids, scores), (p_ids, p_scores) = f32["fused"], f32["plain"]
    differ = (ids != p_ids).nonzero().tolist()
    check(not differ, f"f32 beam ids: K3 != plain from (row, step) "
                      f"{differ[:1]}, scores {scores.tolist()} vs "
                      f"{p_scores.tolist()}")
    rel = ((scores - p_scores).abs() / p_scores.abs()).max().item()
    check(rel <= 1e-4, f"f32 beam scores: K3 vs plain relative {rel}")
    resc = (scores[:, None] - _rescore(f32["model"], image, f32["settings"],
                                       ids)).abs().max().item()
    check(resc <= 1e-3, f"f32 beam scores vs rescoring: {resc}")
    resc_b = (scores - _rescore_batch_b(f32["model"], image, f32["settings"],
                                        ids)).abs().max().item()
    lengths = _lengths(ids, 3)
    check(bool((lengths > T_MAX // 2).all()), f"f32 beam lengths {lengths}")
    legs["float32"] = {"ids_equal": True, "score_rel_err": rel,
                       "rescore_abs_err": resc,
                       "rescore_abs_err_batch_b": resc_b,
                       "lengths": lengths.tolist(),
                       "scores": scores.tolist()}
    del f32
    bf16 = _beam_leg(argv, image, device, "bfloat16")
    (ids, scores), (p_ids, p_scores) = bf16["fused"], bf16["plain"]
    check(bool(torch.isfinite(scores).all() & torch.isfinite(p_scores).all()),
          "bf16 beam scores not finite")
    legs["bfloat16"] = {
        "rows_equal": int((ids == p_ids).all(1).sum().item()),
        "rows": BATCH, "lengths": _lengths(ids, 3).tolist(),
        "score_abs_diff": (scores - p_scores).abs().max().item()}
    del bf16
    emit({"phase": "decode", "records": FT_RECORDS, "batch": BATCH,
          "tokens": T_MAX, "beam": BEAM, "runs": runs, "beam_parity": legs,
          "beam4_over_greedy_tok_s": runs["beam4"]["decode_tokens_per_s"]
          / runs["greedy"]["decode_tokens_per_s"]})
    return {"K3": total}


def write_clf_data(d: str, vocab: str,
                   train_batches: int = CLF_TRAIN_BATCHES) -> str:
    """The classification fixture under ``d/clf_data``: Train.jsonl
    (``train_batches`` batches of CLF_B), Valid.jsonl and Test.jsonl (one
    batch each) from ``synthetic_clf_records`` over the 14 CheXpert label
    names, every label of valid and test also in train; each report 20-300
    words of the synthetic vocabulary, so ``txt_len`` spans the 256-position
    text window; CLF_IMAGES shared 512-px PNGs.  Returns the directory."""
    from PIL import Image

    data = os.path.join(d, "clf_data")
    os.makedirs(data, exist_ok=True)
    rng = np.random.default_rng(SEED + 5)
    for j in range(CLF_IMAGES):
        Image.fromarray(rng.integers(0, 255, (IMG, IMG), np.uint8),
                        "L").save(os.path.join(data, f"img{j}.png"),
                                  format="PNG")
    with open(vocab) as f:
        words = [w.strip() for w in f][5:]
    n_train = train_batches * CLF_B
    recs = synthetic_clf_records(n_train + 2 * CLF_B, CHEXPERT, seed=SEED)
    for i, r in enumerate(recs):
        r["img"] = f"img{i % CLF_IMAGES}.png"
        r["text"] = " ".join(words[j] for j in rng.integers(
            0, len(words), int(rng.integers(20, 301))))
    train_labels, _ = get_labels_and_frequencies(recs[:n_train])
    for r in recs[n_train:]:
        check(set(r["label"].split(", ")) <= set(train_labels),
              f"record {r['id']}'s labels are not all in train")
    for name, part in (("Train", recs[:n_train]),
                       ("Valid", recs[n_train:n_train + CLF_B]),
                       ("Test", recs[n_train + CLF_B:])):
        with open(os.path.join(data, f"{name}.jsonl"), "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in part)
    return data


def _clf_argv(d: str, vocab: str, data: str) -> list:
    """The classification CLI's arguments: its defaults, the train phase's
    pretrain checkpoints as --loaddir, one epoch and the test."""
    return ["--data_path", data, "--vocab_file", vocab,
            "--savedir", os.path.join(d, "clf_run"),
            "--loaddir", os.path.join(d, "pretrain_run"),
            "--max_epochs", "1", "--do_test", "true", "--device", "cuda"]


def _check_clf_metrics(metrics: dict, labels: np.ndarray, what: str) -> None:
    """Finite F1; each class's AUROC finite, nan only where the split holds
    one label value for that class."""
    check(all(np.isfinite(metrics[k]) for k in ("micro_f1", "macro_f1",
                                                 "micro_roc_auc")),
          f"{what} metrics {metrics}")
    for c, auc in enumerate(metrics["per_class_auroc"].values()):
        one_value = labels[:, c].min() == labels[:, c].max()
        check(np.isfinite(auc) != one_value,
              f"{what} class {c} AUROC {auc} (one label value: {one_value})")


def phase_classify(d: str, vocab: str, device) -> dict:
    """The classification CLI's entry point at its defaults; returns the
    launch counts."""
    data = write_clf_data(d, vocab)
    argv = _clf_argv(d, vocab, data)
    args = classification_main.build_parser().parse_args(argv)
    labels, _ = get_labels_and_frequencies(os.path.join(data, "Train.jsonl"))
    cfg = classification_main.config_from_args(args, labels)
    with torch.device("meta"):
        own = classify.build_model(cfg, len(labels)).state_dict()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = classification_main.main(argv)
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    row = out["epochs"][0]
    check(row["micro_steps"] == CLF_TRAIN_BATCHES and
          np.isfinite(row["train_loss"]), f"classify epoch {row}")
    # two eval batches: valid and test, one each
    want = {"K1": 12 * CLF_TRAIN_BATCHES + 12 * 2,
            "K2": 12 * CLF_TRAIN_BATCHES, "K3": 0, "K4": 0}
    check(counts == want, f"classify launches {counts} != {want}")
    shared = sorted(k for k in own if k.startswith("enc.")
                    and not k.endswith("num_batches_tracked"))
    check(out["merged"] == shared, f"merged {len(out['merged'])} of the "
                                   f"{len(shared)} shared enc.* tensors")
    tok = BertTokenizer.from_vocab_file(vocab, remap_unused=False)
    for name, metrics in (("Valid", row), ("Test", out["test"])):
        ds = ClassificationDataset(
            os.path.join(data, f"{name}.jsonl"), tok, labels,
            cfg.max_seq_len, cfg.num_image_embeds, cfg.img_size,
            image_loader=lambda _: np.zeros((1, 1, 3), np.uint8))
        _check_clf_metrics(metrics, np.stack(
            [ds[i]["label"] for i in range(len(ds))]), name)
    run = os.path.join(args.savedir, args.save_name)
    for f in (f"{args.save_name}.csv", "model.0.bin", "model.best.bin",
              "metrics.jsonl"):
        check(os.path.exists(os.path.join(run, f)), f"classify wrote no {f}")
    saved = torch.load(os.path.join(run, "model.0.bin"), map_location="cpu",
                       weights_only=True, mmap=True)
    check(sorted(saved) == sorted(own), "model.0.bin keys differ from the "
                                        "MMBT layout")
    del saved
    emit({"phase": "classify", "train_records": CLF_TRAIN_BATCHES * CLF_B,
          "batch": CLF_B, "seq": CLF_L, "labels": len(labels),
          "micro_steps": row["micro_steps"], "merged_tensors":
          len(out["merged"]), "train_loss": row["train_loss"],
          "examples_per_s": row["examples_per_s"],
          "ms_per_micro_step": row["epoch_time_s"] / row["micro_steps"]
          * 1e3, "epoch_s": row["epoch_time_s"], "wall_s": wall,
          "peak_mem_gib": peak,
          "valid": {k: row[k] for k in ("micro_roc_auc", "macro_roc_auc",
                                         "micro_f1", "macro_f1")},
          "test": {k: out["test"][k] for k in ("micro_roc_auc",
                                                "macro_roc_auc", "micro_f1",
                                                "macro_f1")},
          "launches": counts,
          "launches_per_micro_step": {"K1": 12, "K2": 12},
          "k1_per_eval_batch": 12})
    return counts


def _clf_setup(data: str, vocab: str):
    """(config at the CLI's defaults, train dataset, pos_weight on the
    CPU, cls id, sep id) for the classification fixture in ``data``."""
    args = classification_main.build_parser().parse_args(
        ["--data_path", data, "--vocab_file", vocab])
    train = os.path.join(data, "Train.jsonl")
    labels, freqs = get_labels_and_frequencies(train)
    cfg = classification_main.config_from_args(args, labels)
    tok = BertTokenizer.from_vocab_file(vocab, remap_unused=False)
    ds = ClassificationDataset(train, tok, labels, cfg.max_seq_len,
                               cfg.num_image_embeds, cfg.img_size)
    pw = torch.from_numpy(pos_weights(freqs, labels, len(ds)))
    return cfg, ds, pw, tok.vocab["[CLS]"], tok.vocab["[SEP]"]


def _clf_parity_step(cfg, ds, pw, cls_id: int, sep_id: int, device,
                     compute_dtype: str) -> dict:
    """One classification step at full width, batch 4, fused_ln on, dropout
    0.1, the trunk trained, in ``compute_dtype``, by both paths
    (_kernel_and_plain)."""
    cfg = dataclasses.replace(cfg, bert=dataclasses.replace(
        cfg.bert, compute_dtype=compute_dtype, fused_ln=True))
    batch = pretrain_lib.to_device(next(iter(BatchLoader(ds, 4,
                                                         shuffle=False))),
                                   device)
    model = classify.build_model(cfg, len(cfg.labels))
    init_weights(model, SEED)
    model.to(device)
    pw = pw.to(device)

    def loss_fn(attention_fn):
        return classify.loss_and_logits(
            model, batch, DropoutRNG(SEED + 3, device), cfg, pw, cls_id,
            sep_id, attention_fn=attention_fn)[0]

    return _kernel_and_plain(
        model, loss_fn, _plain_attention(
            full_spec(batch["txt_len"]), CLF_IMG_BLOCK, fa.FAMILY_PRETRAIN,
            cfg.bert.attention_probs_dropout_prob),
        f"classify {compute_dtype}")


def phase_clf_steps(data: str, vocab: str, device) -> dict:
    """The classification step on one device-resident batch of CLF_B at the
    CLI's defaults (trunk trained): steady ms per micro-step with fused_ln
    off and on (2 of warmup, 4 timed; exactly 12 K1 + 12 K2, and with
    fused_ln 24 K3 + 24 K4, per micro-step), peak memory; then train-parity's
    f32 leg on one step at batch 4 (the trunk trained).  No bf16 leg: its
    loss, a mean of 4 x 14 BCE terms, moves under the kernels' bf16
    rounding of P by about twice the plain path's own bf16-vs-f32 distance
    (1.95x on an H100), so train-parity's limit of 2x would decide nothing.
    Returns the fused run's launch counts."""
    cfg, ds, pw, cls_id, sep_id = _clf_setup(data, vocab)
    batch = pretrain_lib.to_device(next(iter(BatchLoader(ds, CLF_B,
                                                         shuffle=False))),
                                   device)
    timing, peak = {}, {}
    for fused in (False, True):
        c = dataclasses.replace(cfg, bert=dataclasses.replace(
            cfg.bert, fused_ln=fused))
        state = classify.init_state(c, len(cfg.labels), t_total=100,
                                    seed=SEED, device=device)
        name = "fused" if fused else "unfused"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        timing[name] = _steady_ms(state, classify.make_train_step(
            c, pw.to(device), cls_id, sep_id), batch)
        counts = read_counts()
        peak[name] = torch.cuda.max_memory_allocated() / 2 ** 30
        del state
        n = 2 + 4
        want = {"K1": 12 * n, "K2": 12 * n, "K3": 24 * n if fused else 0,
                "K4": 24 * n if fused else 0}
        check(counts == want, f"clf-steps {name} launches {counts} != "
                              f"{want}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    legs = {"float32": _clf_parity_step(cfg, ds, pw, cls_id, sep_id, device,
                                        "float32")}
    rec = {"phase": "clf-steps", "batch": CLF_B, "seq": CLF_L,
           "steady_ms_per_micro_step": timing,
           "steady_examples_per_s": {k: CLF_B / v * 1e3
                                     for k, v in timing.items()},
           "peak_mem_gib": peak, "launches_fused": counts,
           "parity": {"tf32": False, "batch": 4, "dropout": 0.1,
                      "fused_ln": True}}
    _check_parity_legs(legs, rec["parity"], "clf-steps")
    emit(rec)
    return counts


def write_retrieval_data(d: str, vocab: str) -> dict:
    """The retrieval fixture under ``d/retrieval_data``: train.jsonl
    (RET_TRAIN_RECORDS records over 4 labels, reports of 20-300 words of
    the synthetic vocabulary, so the text lengths span the 254-position
    window), valid.jsonl and test.jsonl (RET_VALID_QUERIES and
    RET_TEST_QUERIES pools of RET_POOL candidates, the first of each
    aligned), over 8 shared 512-px PNGs.  Returns the three paths."""
    from PIL import Image

    data = os.path.join(d, "retrieval_data")
    os.makedirs(data, exist_ok=True)
    rng = np.random.default_rng(SEED + 7)
    for j in range(8):
        Image.fromarray(rng.integers(0, 255, (IMG, IMG), np.uint8),
                        "L").save(os.path.join(data, f"img{j}.png"),
                                  format="PNG")
    with open(vocab) as f:
        words = [w.strip() for w in f][5:]

    def record(i: int, **kw) -> dict:
        text = " ".join(words[j] for j in rng.integers(
            0, len(words), int(rng.integers(20, 301))))
        return dict(id=str(i), label=f"label{rng.integers(4)}", text=text,
                    img=f"img{rng.integers(8)}.png", **kw)

    paths = {}
    for name, n, pool in (("train", RET_TRAIN_RECORDS, None),
                          ("valid", RET_VALID_QUERIES * RET_POOL, RET_POOL),
                          ("test", RET_TEST_QUERIES * RET_POOL, RET_POOL)):
        paths[name] = os.path.join(data, f"{name}.jsonl")
        with open(paths[name], "w") as f:
            for i in range(n):
                kw = {} if pool is None else {
                    "is_aligned": [int(i % pool == 0)]}
                f.write(json.dumps(record(i, **kw)) + "\n")
    return paths


def _retrieval_argv(d: str, vocab: str, paths: dict, out: str) -> list:
    """The retrieval CLI's arguments: its defaults, the train phase's
    pretrain checkpoint, one epoch, the valid pool during training and the
    test pool after it, RET_POOL candidates per query."""
    return ["--train_dataset", paths["train"],
            "--label_conditioned_valid_dataset", paths["valid"],
            "--label_conditioned_test_dataset", paths["test"],
            "--vocab_file", vocab, "--output_path", out,
            "--load_pretrained_model",
            os.path.join(d, "pretrain_run", "model.0.bin"),
            "--epochs", "1", "--eval_during_training", "true",
            "--do_test", "true", "--eval_len_size", str(RET_POOL),
            "--device", "cuda"]


def _check_retrieval_metrics(res: dict, what: str) -> None:
    hits = res["hits"]["i2t_retrieval"]
    check(all(0.0 <= x <= 1.0 for x in [res["mrr"], *hits.values()]),
          f"{what} metrics {res}")


def phase_retrieve(d: str, vocab: str, device) -> tuple:
    """The retrieval CLI's entry point at its defaults (CXRBERT branch);
    returns (launch counts, the fixture's paths)."""
    paths = write_retrieval_data(d, vocab)
    out = os.path.join(d, "retrieval_run")
    argv = _retrieval_argv(d, vocab, paths, out)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res = retrieval_main.main(argv)
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    row, test = res["epochs"][0], res["test"]
    steps = RET_TRAIN_RECORDS // RET_PAIRS
    check(row["micro_steps"] == steps and np.isfinite(row["train_loss"]),
          f"retrieve epoch {row}")
    check(res["loaded"] == argv[argv.index("--load_pretrained_model") + 1],
          f"retrieve loaded {res['loaded']}")
    queries = RET_VALID_QUERIES + RET_TEST_QUERIES
    score_batches = queries * RET_POOL // RET_PAIRS
    want = {"K1": 12 * steps + 12 * score_batches, "K2": 12 * steps,
            "K3": 0, "K4": 0}
    check(counts == want, f"retrieve launches {counts} != {want}")
    check(0.0 <= row["mrr"] <= 1.0, f"retrieve valid mrr {row}")
    _check_retrieval_metrics(test, "retrieve test")
    with open(os.path.join(out, "rank_result_at_eval.json")) as f:
        ranks = [json.loads(line) for line in f]
    check(len(ranks) == queries, f"{len(ranks)} rank lines for {queries} "
                                 "queries")
    args = retrieval_main.build_parser().parse_args(argv)
    model = retrieve_lib.build_model(retrieval_main.config_from_args(args))
    check(load_cxrbert_checkpoint(model, os.path.join(out, "model.0.bin"))
          == [], "model.0.bin holds keys the model lacks")
    del model
    emit({"phase": "retrieve", "train_records": RET_TRAIN_RECORDS,
          "pairs": RET_PAIRS, "rows": RET_B, "seq": RET_L,
          "micro_steps": steps, "train_loss": row["train_loss"],
          "train_acc": row["train_acc"],
          "examples_per_s": row["examples_per_s"],
          "ms_per_micro_step": row["epoch_time_s"] / steps * 1e3,
          "epoch_s": row["epoch_time_s"], "wall_s": wall,
          "peak_mem_gib": peak,
          "pools": {"eval_len_size": RET_POOL,
                    "valid_queries": RET_VALID_QUERIES,
                    "test_queries": RET_TEST_QUERIES},
          "valid": {"mrr": row["mrr"],
                    "candidates_per_s": row["candidates_per_s"]},
          "test": {"mrr": test["mrr"], **test["hits"]["i2t_retrieval"],
                   "candidates_per_s": test["candidates_per_s"]},
          "rank_lines": len(ranks), "launches": counts,
          "launches_per_micro_step": {"K1": 12, "K2": 12},
          "k1_per_score_batch": 12})
    return counts, paths


def _retrieval_batch(paths: dict, vocab: str, cfg, pairs: int, device):
    tok = BertTokenizer.from_vocab_file(vocab, remap_unused=False)
    ds = CXRRetrievalDataset(paths["train"], tok, cfg, is_train=True,
                             seed=SEED)
    return pretrain_lib.to_device(collate_pairs([ds[i]
                                                 for i in range(pairs)]),
                                  device)


def _retr_parity_step(cfg, paths: dict, vocab: str, device) -> dict:
    """One retrieval step at full width, 2 pairs (4 rows), fused_ln on,
    dropout 0.1, in f32, by both paths (_kernel_and_plain)."""
    cfg = dataclasses.replace(cfg, bert=dataclasses.replace(
        cfg.bert, compute_dtype="float32", fused_ln=True))
    batch = _retrieval_batch(paths, vocab, cfg, 2, device)
    model = retrieve_lib.build_model(cfg)
    init_weights(model, SEED)
    model.to(device)
    pix = retrieve_lib.score_pixel_indices(cfg).to(device)

    def loss_fn(attention_fn):
        return retrieve_lib.loss_and_metrics(
            model, batch, DropoutRNG(SEED + 3, device), pix, cfg,
            attention_fn=attention_fn)[0]

    return _kernel_and_plain(
        model, loss_fn, _plain_attention(
            batch["mask_spec"], RET_IMG_BLOCK, fa.FAMILY_PRETRAIN,
            cfg.bert.attention_probs_dropout_prob), "retrieve float32")


def phase_retr_steps(paths: dict, vocab: str, device) -> None:
    """The retrieval step on one device-resident batch of RET_PAIRS pairs
    (RET_B rows) at the CLI's defaults: steady ms per micro-step (2 of
    warmup, 4 timed; exactly 12 K1 + 12 K2 per micro-step) and peak memory;
    the steady ms of the score step on RET_PAIRS candidates (12 K1 each);
    then train-parity's f32 leg on one step of 2 pairs (TF32 off)."""
    cfg = retrieval_main.config_from_args(
        retrieval_main.build_parser().parse_args(["--vocab_file", vocab]))
    batch = _retrieval_batch(paths, vocab, cfg, RET_PAIRS, device)
    state = retrieve_lib.init_state(cfg, seed=SEED, device=device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    step_ms = _steady_ms(state, retrieve_lib.make_train_step(cfg), batch)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n = 2 + 4
    want = {"K1": 12 * n, "K2": 12 * n, "K3": 0, "K4": 0}
    check(counts == want, f"retr-steps launches {counts} != {want}")
    score_step = retrieve_lib.make_score_step(cfg)
    half = {k: v[:RET_PAIRS] for k, v in batch.items()}
    reset_counts()
    score_ms = _steady_ms(state.model, lambda m, b, g: score_step(m, b),
                          half)
    check(read_counts()["K1"] == 12 * n, "score step launches")
    del state, batch, half
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    legs = {"float32": _retr_parity_step(cfg, paths, vocab, device)}
    rec = {"phase": "retr-steps", "pairs": RET_PAIRS, "rows": RET_B,
           "seq": RET_L, "steady_ms_per_micro_step": step_ms,
           "steady_examples_per_s": RET_B / step_ms * 1e3,
           "peak_mem_gib": peak, "launches": counts,
           "score_ms_per_batch": score_ms,
           "steady_candidates_per_s": RET_PAIRS / score_ms * 1e3,
           "parity": {"tf32": False, "pairs": 2, "dropout": 0.1,
                      "fused_ln": True}}
    _check_parity_legs(legs, rec["parity"], "retr-steps")
    emit(rec)


def phase_retrieve_cnn(d: str, vocab: str, paths: dict, device) -> None:
    """The retrieval CLI's --CXRBERT false branch (CNN_BERT, the trunk
    trained) at the CLI's default batch of RET_PAIRS pairs (140 trained
    images), one epoch and the test pool: finite loss, metrics in [0, 1],
    model.0.bin in the CNN_BERT layout loading strictly, no kernel launched
    (its text encoder takes the dense bias); peak memory, examples/s."""
    out = os.path.join(d, "retrieval_cnn_run")
    argv = ["--train_dataset", paths["train"],
            "--label_conditioned_test_dataset", paths["test"],
            "--vocab_file", vocab, "--output_path", out,
            "--CXRBERT", "false",
            "--epochs", "1", "--do_test", "true",
            "--eval_len_size", str(RET_POOL), "--device", "cuda"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res = retrieval_main.main(argv)
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    row = res["epochs"][0]
    args = retrieval_main.build_parser().parse_args(argv)
    check(args.batch_size == RET_PAIRS, f"the CLI's default batch is "
                                        f"{args.batch_size} pairs")
    steps = RET_TRAIN_RECORDS // RET_PAIRS
    check(row["micro_steps"] == steps and np.isfinite(row["train_loss"]),
          f"retrieve-cnn epoch {row}")
    check(not any(counts.values()), f"retrieve-cnn launches {counts}")
    _check_retrieval_metrics(res["test"], "retrieve-cnn test")
    model = retrieve_lib.build_cnn_model(
        retrieval_main.config_from_args(args))
    check(load_cnn_bert_checkpoint(model, os.path.join(out, "model.0.bin"))
          == [], "CNN_BERT model.0.bin holds keys the model lacks")
    emit({"phase": "retrieve-cnn", "pairs": RET_PAIRS,
          "rows": 2 * RET_PAIRS, "default_pairs": True,
          "micro_steps": steps, "train_loss": row["train_loss"],
          "examples_per_s": row["examples_per_s"],
          "ms_per_micro_step": row["epoch_time_s"] / steps * 1e3,
          "wall_s": wall, "peak_mem_gib": peak,
          "test": {"mrr": res["test"]["mrr"],
                   "candidates_per_s": res["test"]["candidates_per_s"]},
          "launches": counts})


GRAPH_LIMIT = 1e-3  # of a tensor's scale: the single-step card limit
# under the default algorithms, the floor of the graphed run's mean
# distance (per tensor, over its scale) from the nearer of two eager runs:
# the eager runs' own spread is one sample, and in the retrieval leg two
# runs, eager or graphed, read 2.6e-4 to 4.9e-3 apart on an H100, while a
# graph that replays stale or wrong inputs moves most tensors by O(1)
DEFAULT_FLOOR = 1e-2
# the finetune CLI at k = 4 across --drop_after may reserve this much more
# than one epoch: successive runs in one process drift by up to ~0.4 GiB,
# while keeping the first ratio's graphs alive costs ~4 GiB (H100)
DROP_AFTER_SLACK_GIB = 1.0


def _group(batches: list) -> dict:
    return {k: torch.stack([b[k] for b in batches]) for k in batches[0]}


def _replay_masks(device) -> dict:
    """K1-K4 each captured alone in a CUDA graph with a device seed (the
    word w plus the call's constant, as a graphed micro-step launches
    them), the keep mask read back from its output (K1: q = k = 0 and V
    one-hot over the 64 keys; K2: dV with dO one-hot; K3: x = 1, res = 0;
    K4: dx == 0 where x was dropped), bf16, rate 0.1: the mask of a replay
    with w = s1 equals an eager launch's from the same device seed and the
    plain version's, a replay with w = s2 draws another, and the keep
    fraction is 0.9 +- 0.005."""
    from medvill_torch.ops.dropout import GOLDEN, DeviceSeed
    B, L, rows, rate = 4, HEAD_DIM, 2048, 0.1
    dt = torch.bfloat16
    word = torch.zeros(1, dtype=torch.int32, device=device)
    seed = DeviceSeed(word, (3 * GOLDEN) & 0xFFFFFFFF)
    spec = torch.tensor([[int(MaskVariant.FULL), L - 2]] * B,
                        dtype=torch.int32, device=device)
    kw = dict(img_block=2, l_real=L, family=fa.FAMILY_PRETRAIN, rate=rate,
              seed=seed)
    z = torch.zeros(B, L, HEADS, HEAD_DIM, device=device, dtype=dt)
    eye = torch.zeros_like(z)
    eye[:, :, :, :L] = torch.eye(L, device=device, dtype=dt)[:, None]
    gen = torch.Generator(device=device).manual_seed(SEED + 9)
    x, res, dy = (torch.randn(rows, H, device=device, generator=gen).to(dt)
                  for _ in range(3))
    one, zero = torch.ones(H, device=device), torch.zeros(H, device=device)
    o, lse = fa.attn_fwd(z, z, eye, spec, **kw)
    launches = {
        "K1": (lambda: fa.attn_fwd(z, z, eye, spec, **kw)[0],
               lambda out: (out > 0).permute(0, 2, 1, 3),
               lambda: fa.keep_mask(seed, B, HEADS, L, rate, device)),
        "K2": (lambda: fa.attn_bwd(z, z, eye, o, eye, lse, spec, **kw)[2],
               lambda out: (out > 0).permute(0, 2, 3, 1),
               lambda: fa.keep_mask(seed, B, HEADS, L, rate, device)),
        "K3": (lambda: fused_ln.fused_ln_fwd(
            torch.ones_like(x), torch.zeros_like(x), one, zero, rate=rate,
            eps=1e-12, seed=seed), lambda out: out > 0,
               lambda: fused_ln.keep_mask(seed, rows, H, rate, device)),
        "K4": (lambda: fused_ln.fused_ln_bwd(
            x, res, one, dy, rate=rate, eps=1e-12, seed=seed)[0],
               lambda out: out != 0,
               lambda: fused_ln.keep_mask(seed, rows, H, rate, device))}
    side = torch.cuda.Stream(device)
    out = {}
    for kid, (launch, mask_of, plain) in launches.items():
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            launch()  # lazily made scratch, outside the capture
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side,
                              capture_error_mode="thread_local"):
            captured = launch()
        masks = []
        for s in (1234, 98765, 1234):
            word.fill_(s)
            graph.replay()
            masks.append(mask_of(captured).clone())
        word.fill_(1234)
        eager = mask_of(launch())
        want = plain()
        frac = masks[0].float().mean().item()
        check(torch.equal(masks[0], eager) and torch.equal(masks[2], eager),
              f"{kid}: a replay's mask differs from the eager launch's")
        check(torch.equal(eager, want), f"{kid}: mask differs from plain")
        check(not torch.equal(masks[0], masks[1]),
              f"{kid}: two seeds, one mask")
        check(abs(frac - (1 - rate)) <= 0.005, f"{kid} keep fraction {frac}")
        out[kid] = {"mask_equals_eager_and_plain": True,
                    "fresh_per_replay": True, "keep_fraction": frac}
        del graph, captured
    return out


def _peaks() -> dict:
    return {"peak_alloc_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "peak_reserved_gib": torch.cuda.max_memory_reserved() / 2 ** 30}


def _run(make_state, make_step, batches: list, k) -> tuple:
    """len(batches) micro-steps from a fresh state and a host generator of
    seed SEED, one at a time (``k`` None: eager) or k per dispatch (CUDA
    graphs).  Returns (every floating tensor of the state dict and the
    metrics, by name, and the launch counts)."""
    from medvill_torch.train.dispatch import MultiStep
    state = make_state()
    step = make_step() if k is None else MultiStep(make_step(), k)
    gen = torch.Generator().manual_seed(SEED)
    reset_counts()
    if k is None:
        out = [step(state, b, gen) for b in batches]
    else:
        out = [step(state, _group(batches[i:i + k]), gen)
               for i in range(0, len(batches), k)]
    counts = read_counts()
    tensors = {f"param {n}": v.detach().clone()
               for n, v in state.model.state_dict().items()
               if v.is_floating_point()}
    tensors.update({f"metric {m}": torch.cat([o[m].reshape(-1) for o in out])
                    for m in out[0]})
    del state, step, out
    torch.cuda.empty_cache()
    return tensors, counts


def _distance(got: dict, want: dict) -> dict:
    """Per tensor, the largest difference over the tensor's scale (its
    largest entry in ``want``; a key bias's, its layer's key weights':
    _compare_grads' rule): the worst, the mean over the tensors, and how
    many are bitwise equal."""
    rels = {}
    for name, b in want.items():
        a = got[name]
        if torch.equal(a, b):
            rels[name] = 0.0
            continue
        ref = b
        if name.endswith("attention.self.key.bias"):
            ref = want[name[:-len("bias")] + "weight"]
        rels[name] = ((a.float() - b.float()).abs().max()
                      / ref.float().abs().max().clamp(min=1e-30)).item()
    worst_name = max(rels, key=rels.get)
    return {"tensors": len(rels),
            "bitwise_equal": sum(r == 0.0 for r in rels.values()),
            "worst_rel_diff": rels[worst_name], "worst": worst_name,
            "mean_rel_diff": sum(rels.values()) / len(rels)}


def _graphed_vs_eager(make_state, make_step, batches: list, k: int,
                      what: str, control: bool) -> dict:
    """len(batches) eager micro-steps against len(batches) / k dispatches of
    k (CUDA graphs) from equal states and generators of one seed, under
    PyTorch's deterministic algorithms: every parameter and buffer and the
    stacked metrics within GRAPH_LIMIT of their scale (_distance; the worst
    printed; bitwise equal expected: the same kernels in the same order),
    and the launches per micro-step equal.  With ``control``, again under
    PyTorch's default algorithms, as the CLIs run: there some library
    kernels sum with atomics (the trained trunk's convolutions among them),
    so two eager runs differ, and Adam turns a gradient's last-bit noise
    into a move of lr wherever the gradient is near 0.  So a second eager
    run from the same state and seeds measures that spread, and the graphed
    run's mean distance from the nearer eager run (over tensors, each over
    its scale) must stay within 3 x the eager runs' mean distance from each
    other, floored at DEFAULT_FLOOR; the worst tensors are printed."""
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        want, eager_counts = _run(make_state, make_step, batches, None)
        got, counts = _run(make_state, make_step, batches, k)
    finally:
        torch.use_deterministic_algorithms(deterministic)
    check(counts == eager_counts, f"{what}: graphed launches {counts} != "
                                  f"eager {eager_counts}")
    d = _distance(got, want)
    check(d["worst_rel_diff"] <= GRAPH_LIMIT,
          f"{what}: {d['worst']} {d['worst_rel_diff']} > {GRAPH_LIMIT} of "
          f"scale")
    n = len(batches)
    rec = {"micro_steps": n, "k": k, "dispatches": n // k,
           "launches_per_micro_step": {c: v / n for c, v in counts.items()},
           **d, "limit": GRAPH_LIMIT}
    del want, got
    if control:
        torch.use_deterministic_algorithms(False)
        try:
            first, _ = _run(make_state, make_step, batches, None)
            second, _ = _run(make_state, make_step, batches, None)
            graphed, _ = _run(make_state, make_step, batches, k)
        finally:
            torch.use_deterministic_algorithms(deterministic)
        spread = _distance(second, first)
        got = [_distance(graphed, first), _distance(graphed, second)]
        nearer = min(d["mean_rel_diff"] for d in got)
        limit = max(DEFAULT_FLOOR, 3.0 * spread["mean_rel_diff"])
        check(nearer <= limit,
              f"{what}, default algorithms: graphed vs eager mean "
              f"{nearer} > {limit} (eager vs eager "
              f"{spread['mean_rel_diff']})")
        rec["default_algorithms"] = {"eager_vs_eager": spread,
                                     "graphed_vs_eager": got,
                                     "limit_mean_rel_diff": limit}
    return rec


def _busy(fn, micro_steps: int) -> tuple:
    """(wall ms per micro-step, device-busy ms per micro-step, idle share,
    host kernel and graph launches per micro-step) of ``fn()`` under
    torch.profiler: the kernels' device time summed (graph-launched
    kernels included)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avgs = prof.key_averages()
    busy = sum(getattr(e, "self_device_time_total", 0.0) for e in avgs
               if str(getattr(e, "device_type", "")).endswith("CUDA")
               and not e.key.startswith(("Optimizer.step#",
                                         "ProfilerStep#")))
    launches = sum(e.count for e in avgs if e.key in (
        "cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
        "cudaGraphLaunch"))
    wall_ms = wall / micro_steps * 1e3
    busy_ms = busy / 1e3 / micro_steps
    return wall_ms, busy_ms, 1 - busy_ms / wall_ms, launches / micro_steps


def _graph_timing(make_state, make_step, batch: dict, k: int,
                  profile: bool, rounds: int = 2) -> dict:
    """Steady ms per micro-step on one resident batch, eager (k single
    steps) and graphed (one dispatch of k over the batch stacked k times),
    in turns eager, graphed, graphed, eager, ``rounds`` dispatches each
    after warmup (both graphs captured); with ``profile``, each under
    torch.profiler instead (_busy)."""
    from medvill_torch.train.dispatch import MultiStep
    group = _group([batch] * k)
    names = ("eager", "graphed")
    states = {name: make_state() for name in names}
    steps = {"eager": make_step(), "graphed": MultiStep(make_step(), k)}
    gens = {name: torch.Generator().manual_seed(SEED) for name in names}

    def dispatch(name):
        if name == "graphed":
            steps[name](states[name], group, gens[name])
            return
        for _ in range(k):
            steps[name](states[name], batch, gens[name])

    # the first micro-step of each kind runs eagerly, its second captures;
    # a capture empties the allocator's cache, so the eager path warms last
    every = states["graphed"].tx.every
    for name in names[::-1]:
        for _ in range(-(-2 * max(k, every) // k)):
            dispatch(name)
    out = {}
    if profile:
        for name in names:
            wall, busy, idle, launches = _busy(lambda: dispatch(name), k)
            out[name] = {"profiled_ms_per_micro_step": wall,
                         "device_busy_ms_per_micro_step": busy,
                         "device_idle_share": idle,
                         "host_launches_per_micro_step": launches}
    else:
        out = {name: {"ms_per_micro_step": []} for name in names}
        for name in ("eager", "graphed", "graphed", "eager"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(rounds):
                dispatch(name)
            torch.cuda.synchronize()
            out[name]["ms_per_micro_step"].append(
                (time.perf_counter() - t0) / (rounds * k) * 1e3)
    del states, steps
    torch.cuda.empty_cache()
    return out


def _with_rate(cfg, rate):
    """``cfg`` with both dropout rates at ``rate`` (None: as it is)."""
    if rate is None:
        return cfg
    return dataclasses.replace(cfg, bert=dataclasses.replace(
        cfg.bert, hidden_dropout_prob=rate,
        attention_probs_dropout_prob=rate))


def _graph_legs(ft_argv: list, data: str, vocab: str, clf_data: str,
                ret_paths: dict, device) -> dict:
    """graph-steps' legs: name -> (makers(cfg) -> (make_state, make_step),
    the CLI's config, the device batches, k, the dropout rates compared
    (None: the config's own))."""
    ft_cfg = finetune_main.config_from_args(
        finetune_main.build_parser().parse_args(ft_argv))
    tok = BertTokenizer.from_vocab_file(vocab, remap_unused=True)
    ft_batches = [pretrain_lib.to_device(b, device) for b in BatchLoader(
        Img2TxtDataset(ft_cfg.src_file, tok, ft_cfg, seed=SEED), FT_B,
        shuffle=False)][:8]
    pre_cfg = pretrain_main.config_from_args(pretrain_main.build_parser()
                                             .parse_args(
        ["--train_dataset", data, "--vocab_file", vocab]))
    tok = BertTokenizer.from_vocab_file(vocab, remap_unused=False)
    pre_batches = [pretrain_lib.to_device(b, device) for b in BatchLoader(
        CXRPretrainDataset(data, tok, pre_cfg, seed=SEED), PRE_B,
        shuffle=False)][:8]
    ret_cfg = retrieval_main.config_from_args(
        retrieval_main.build_parser().parse_args(["--vocab_file", vocab]))
    ret_ds = CXRRetrievalDataset(ret_paths["train"], tok, ret_cfg,
                                 is_train=True, seed=SEED)
    ret_batches = [pretrain_lib.to_device(collate_pairs(
        [ret_ds[i] for i in range(j * RET_PAIRS, (j + 1) * RET_PAIRS)]),
        device) for j in range(2)] * 2
    clf_cfg, clf_ds, pw, cls_id, sep_id = _clf_setup(clf_data, vocab)
    pw = pw.to(device)
    clf_batches = [pretrain_lib.to_device(b, device) for b in BatchLoader(
        clf_ds, CLF_B, shuffle=False)][:2] * 2

    legs = {
        "finetune": (lambda c: (lambda: finetune_lib.init_state(
            c, t_total=100, seed=SEED, device=device),
            lambda: finetune_lib.make_train_step(c)), ft_cfg, ft_batches,
            4, (0.0, None)),
        "pretrain": (lambda c: (lambda: pretrain_lib.init_state(
            c, seed=SEED, device=device),
            lambda: pretrain_lib.make_train_step(c)), pre_cfg, pre_batches,
            4, (0.0, None)),
        "retrieval": (lambda c: (lambda: retrieve_lib.init_state(
            c, seed=SEED, device=device),
            lambda: retrieve_lib.make_train_step(c)), ret_cfg, ret_batches,
            2, (0.0,)),
        "classification": (lambda c: (lambda: classify.init_state(
            c, len(c.labels), t_total=100, seed=SEED, device=device),
            lambda: classify.make_train_step(c, pw, cls_id, sep_id)),
            clf_cfg, clf_batches, 2, (0.0,))}
    return legs


def phase_graph_steps(ft_argv: list, data: str, vocab: str, clf_data: str,
                      ret_paths: dict, d: str, device) -> dict:
    """k micro-steps per dispatch (train/dispatch.py: CUDA graphs of the
    training micro-step) against eager micro-steps: the masks K1-K4 draw
    from a device seed in a replay (_replay_masks); per leg -- finetune
    (the finetune CLI's defaults, fused_ln on) and pretrain (the pretrain
    CLI's defaults: BAR, batch 36, accumulation 4), two dispatches of 4;
    retrieval (140 rows) and classification (batch 56, the trunk
    trained), two dispatches of 2 -- graphed against eager at dropout 0
    (and 0.1 for finetune and pretrain: the replays draw the eager steps'
    masks), at dropout 0 also under the default algorithms against the
    spread of two eager runs (_graphed_vs_eager), the same launches per
    micro-step, and the steady ms of each in turns; the finetune CLI at
    --steps_per_dispatch 1 and 4 in turns (1, 4, 4, 1), then at 4 across
    --drop_after (its peak reserved memory against one epoch's); last,
    each leg's device busy ms and idle share under torch.profiler (after
    every timed run, so that none is timed after a profile).  Returns the
    k = 4 CLI runs' launches."""
    t_phase = time.perf_counter()
    rec = {"phase": "graph-steps", "replay_masks": _replay_masks(device)}
    # the finetune CLI at --steps_per_dispatch 1 and 4, in turns
    cli = {"k1": [], "k4": []}
    k4_counts = {c: 0 for c in KERNEL_COUNTS}
    for run, k in enumerate((1, 4, 4, 1)):
        argv = ft_argv + ["--steps_per_dispatch", str(k), "--output_dir",
                          os.path.join(d, f"finetune_k{k}_{run}")]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        row = finetune_main.main(argv)["epochs"][0]
        counts = read_counts()
        want = {c: v * FT_MICRO_STEPS for c, v in KERNEL_COUNTS.items()}
        check(row["micro_steps"] == FT_MICRO_STEPS and np.isfinite(
            row["loss"]), f"finetune CLI k {k}: {row}")
        check(counts == want, f"finetune CLI k {k} launches {counts}")
        cli[f"k{k}"].append({"reports_per_s": FT_MICRO_STEPS * FT_B
                             / row["epoch_time_s"],
                             "ms_per_micro_step": row["epoch_time_s"]
                             / FT_MICRO_STEPS * 1e3, "loss": row["loss"],
                             **_peaks()})
        if k == 4:
            k4_counts = {c: k4_counts[c] + v for c, v in counts.items()}
    # two epochs at k = 4 that cross --drop_after: the second epoch's
    # ratio captures new graphs, and the first ratio's pool must go
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    rows = finetune_main.main(ft_argv + [
        "--steps_per_dispatch", "4", "--num_train_epochs", "2",
        "--drop_after", "1", "--max_drop_worst_ratio", "0.2",
        "--output_dir", os.path.join(d, "finetune_k4_drop")])["epochs"]
    counts = read_counts()
    k4_counts = {c: k4_counts[c] + v for c, v in counts.items()}
    one = max(r["peak_reserved_gib"] for r in cli["k4"])
    cross = {"ratios": [r["drop_worst_ratio"] for r in rows],
             "losses": [r["loss"] for r in rows], **_peaks(),
             "one_epoch_k4_peak_reserved_gib": one,
             "limit_peak_reserved_gib": one + DROP_AFTER_SLACK_GIB}
    check([r["drop_worst_ratio"] for r in rows] == [0.0, 0.2]
          and all(np.isfinite(r["loss"]) for r in rows)
          and counts == {c: 2 * v * FT_MICRO_STEPS
                         for c, v in KERNEL_COUNTS.items()},
          f"finetune CLI across --drop_after: {rows} {counts}")
    check(cross["peak_reserved_gib"] <= one + DROP_AFTER_SLACK_GIB,
          f"finetune CLI across --drop_after reserved "
          f"{cross['peak_reserved_gib']} GiB > one epoch's {one} + "
          f"{DROP_AFTER_SLACK_GIB}")
    cli["k4_across_drop_after"] = cross
    rec["finetune_cli"] = cli
    legs = _graph_legs(ft_argv, data, vocab, clf_data, ret_paths, device)
    for name, (makers, cfg, batches, k, rates) in legs.items():
        leg = {"k": k, "batch_rows": int(batches[0][next(iter(
            batches[0]))].shape[0])}
        for rate in rates:
            c = _with_rate(cfg, rate)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            r = _graphed_vs_eager(
                *makers(c), batches, k, f"graph-steps {name} rate {rate}",
                control=rate == 0.0)
            r["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
            leg["dropout_" + ("cli" if rate is None else str(rate))] = r
        torch.cuda.empty_cache()
        leg["timing"] = _graph_timing(*makers(cfg), batches[0], k,
                                      profile=False)
        rec[name] = leg
    for name, (makers, cfg, batches, k, _) in legs.items():
        for path, prof in _graph_timing(*makers(cfg), batches[0], k,
                                        profile=True).items():
            rec[name]["timing"][path].update(prof)
        emit({"phase": "graph-steps-leg", "leg": name, **rec[name]})
    rec["wall_s"] = time.perf_counter() - t_phase
    emit({k: v for k, v in rec.items() if k not in legs})
    return k4_counts



class _LogWatch(logging.Handler):
    """Reads the training CLIs' log from the root logger: the time of the
    first "epoch E it I" line (its loss is read from the device, so the
    first dispatch has ended), each "saved ... in S s", and, when a line
    starts with ``signal_at``, a SIGTERM to this process."""

    def __init__(self, signal_at: str = None):
        super().__init__()
        self.signal_at, self.sent = signal_at, False
        self.first_step = None
        self.save_s: list = []

    def emit(self, record) -> None:
        msg = record.getMessage()
        if self.first_step is None and msg.startswith("epoch ") \
                and " it " in msg:
            self.first_step = time.perf_counter()
        m = re.fullmatch(r"saved .* in ([0-9.]+) s", msg)
        if m:
            self.save_s.append(float(m.group(1)))
        if self.signal_at and not self.sent \
                and msg.startswith(self.signal_at + " "):
            self.sent = True
            os.kill(os.getpid(), signal.SIGTERM)


def _run_cli(main_fn, argv: list, signal_at: str = None) -> tuple:
    """(result, seconds to the first logged dispatch, the logged save
    seconds) of ``main_fn(argv)``, a SIGTERM sent at ``signal_at``."""
    watch = _LogWatch(signal_at)
    logging.getLogger().addHandler(watch)
    t0 = time.perf_counter()
    try:
        out = main_fn(argv)
    finally:
        logging.getLogger().removeHandler(watch)
    check(signal_at is None or watch.sent, f"no log line {signal_at!r}")
    startup = None if watch.first_step is None else watch.first_step - t0
    return out, startup, watch.save_s


class _SignalAtBatch:
    """Wraps a CLI's ``dispatch_loader``: a SIGTERM to this process when the
    ``at``-th item of the first epoch is handed out; counts the items handed
    out from then on."""

    def __init__(self, module, at: int = 0):
        self.module, self.at = module, at
        self.real = module.dispatch_loader
        self.after = 0

    def __enter__(self):
        def wrapped(*a, **kw):
            for i, item in enumerate(self.real(*a, **kw)):
                if i == self.at and not self.after:
                    os.kill(os.getpid(), signal.SIGTERM)
                if i >= self.at:
                    self.after += 1
                yield item

        self.module.dispatch_loader = wrapped
        return self

    def __exit__(self, *exc):
        self.module.dispatch_loader = self.real
        return False


def _same_files(got: str, want: str, names) -> None:
    """Each named checkpoint file of ``got`` equals ``want``'s, tensor by
    tensor bit for bit, every other value equal."""
    def flat(x, where=""):
        if isinstance(x, dict):
            for k, v in x.items():
                yield from flat(v, f"{where}/{k}")
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                yield from flat(v, f"{where}/{i}")
        else:
            yield where, x

    for name in names:
        a, b = (dict(flat(torch.load(os.path.join(d, name),
                                     map_location="cpu", weights_only=True,
                                     mmap=True))) for d in (got, want))
        check(a.keys() == b.keys(), f"{name}: other entries")
        for k, x in a.items():
            same = (torch.equal(x, b[k]) if torch.is_tensor(x)
                    else x == b[k])
            check(same, f"{name}{k} differs from the uninterrupted run's")


def _eval_parity(run: str, test_data: str, vocab: str, device) -> dict:
    """The eval's loss on one test batch from the run's final weights: the
    kernel path (make_eval_step, bf16 compute, K1) against the plain path
    (the attention kernels' plain version, bf16), held as train-parity
    holds a loss (_check_parity_legs' rules (1) and (2)) with the plain
    path in f32 (TF32 off) as the yardstick; then K1 at the eval's call
    (B 36, the batch's BAR spec, rate 0, bf16) against its plain version
    and timed beside its bound, plain version and the library, and the
    eval step's ms per batch (CUDA events, back to back) and its device
    busy ms and idle share (torch.profiler, _busy)."""
    args = pretrain_main.build_parser().parse_args(
        ["--train_dataset", test_data, "--vocab_file", vocab])
    cfg = pretrain_main.config_from_args(args)
    tok = BertTokenizer.from_vocab_file(vocab, remap_unused=False)
    ds = CXRPretrainDataset(test_data, tok, cfg, seed=cfg.seed + 1)
    batch = pretrain_lib.to_device(next(iter(BatchLoader(
        ds, PRE_B, shuffle=False))), device)
    pix = pretrain_lib.eval_pixel_indices(cfg).to(device)
    losses, terms = {}, {}
    for dt in ("bfloat16", "float32"):
        c = dataclasses.replace(cfg, bert=dataclasses.replace(
            cfg.bert, compute_dtype=dt))
        model = pretrain_lib.build_model(c)
        load_cxrbert_checkpoint(model, os.path.join(run, "model.1.bin"))
        model.to(device)
        paths = ("kernel", "plain") if dt == "bfloat16" else ("plain",)
        for path in paths:
            attention_fn = None if path == "kernel" else _plain_attention(
                batch["mask_spec"], PRE_IMG_BLOCK, fa.FAMILY_PRETRAIN, 0.0)
            reset_counts()
            with torch.no_grad(), _loss_terms(
                    model, batch, (pretrain_lib, "_mlm_ce")) as t:
                if path == "kernel":
                    m = pretrain_lib.make_eval_step(c)(model, batch)
                else:
                    m = pretrain_lib.pretrain_loss_and_metrics(
                        model, batch, None, pix, c, train=False,
                        attention_fn=attention_fn)[1]
            counts = read_counts()
            want = 12 if path == "kernel" else 0
            check(counts == {"K1": want, "K2": 0, "K3": 0, "K4": 0},
                  f"eval {dt} {path} launches {counts}")
            losses[f"{path}_{dt}"] = m["loss"].item()
            terms[f"{path}_{dt}"] = torch.cat(t)
        if dt == "bfloat16":
            step = pretrain_lib.make_eval_step(c)
            eval_ms = eager_ms(lambda: step(model, batch), iters=10,
                               warmup=2)
            _, busy_ms, idle, _ = _busy(lambda: step(model, batch), 1)
        del model
    k, p, f = (losses[n] for n in ("kernel_bfloat16", "plain_bfloat16",
                                   "plain_float32"))

    def rms(a, b) -> float:
        return (a - b).square().mean().sqrt().item()

    floor_terms = rms(terms["plain_bfloat16"], terms["plain_float32"])
    dist = rms(terms["kernel_bfloat16"], terms["plain_bfloat16"])
    check(dist <= 2.0 * floor_terms, f"eval loss terms: rms {dist} > 2 x "
                                     f"the plain bf16-vs-f32 {floor_terms}")
    rel, floor = abs(k - p) / abs(p), abs(p - f) / abs(f)
    limit = max(2.0 * floor, 3.0 * floor_terms
                / terms["plain_bfloat16"].numel() ** 0.5 / abs(p))
    check(np.isfinite(k) and rel <= limit,
          f"eval loss {k} vs plain {p}: relative {rel} > {limit}")
    gen = torch.Generator(device=device).manual_seed(SEED + 11)
    q, kk, v, do = (torch.randn(PRE_B, PRE_L, HEADS, HEAD_DIM, device=device,
                                generator=gen).to(torch.bfloat16)
                    for _ in range(4))
    spec = batch["mask_spec"].contiguous()
    kw = dict(img_block=PRE_IMG_BLOCK, l_real=PRE_L,
              family=fa.FAMILY_PRETRAIN, rate=0.0, seed=0)
    err = _attn_errs(q, kk, v, do, spec, kw, "eval call")[0]["o"]
    t = _attn_times(q, kk, v, do, spec, kw, backward=False)
    return {"losses": losses, "loss_rel_err": rel, "loss_rel_limit": limit,
            "loss_terms": int(terms["plain_bfloat16"].numel()),
            "loss_terms_rms_dist": dist,
            "loss_terms_rms_limit": 2.0 * floor_terms,
            "eval_ms_per_batch": eval_ms, "eval_device_busy_ms": busy_ms,
            "eval_device_idle_share": idle,
            "k1": {"max_abs_err": err, "ms": t["k1_ms"],
                   "plain_ms": t["k1_plain_ms"],
                   "bound_ms": t["k1_bound_ms"],
                   "bound_by": t["k1_bound_by"],
                   "library_ms": t["k1_library_ms"]}}


RESUME_EPOCHS, RESUME_K = 2, 2
# the log line of dispatch 1 of epoch 0 at k = 2: the guard reads the flag
# after dispatch 2, 6 micro-steps in, 2 into the accumulation of 4
RESUME_SIGNAL = "epoch 0 it 2"


def phase_resume(d: str, data: str, vocab: str, device) -> tuple:
    """The pretrain CLI at its defaults (BERT-base, 180 random-pixel fibers
    at 512 px, L = 436, BAR, batch 36, accumulation 4) for 2 epochs of 8
    batches over the train phase's records at --steps_per_dispatch 2, with
    --test_dataset (its first 36 records), --watch_interval 1,
    --profile_dir, --log_freq 1 and --save_interval 2 (a full save writes
    ~1.5 GB: fewer saves keep the script's disk writes down; the relaunch
    still saves the epoch it resumed), under PyTorch's deterministic
    algorithms: a real SIGTERM sent when dispatch 1 of epoch 0 is logged
    stops it mid-accumulation (marker 0 / 6, 2 micro-batches summed); the
    same argv relaunched consumes the marker and ends with model.1.bin and
    optim.1.bin equal bit for bit to an uninterrupted run's, and the same
    eval rows; K1 runs 12 times per eval batch; the eval loss within the
    bf16 tolerance of the plain path (_eval_parity); the profile holds the
    attention kernels.  Returns (the relaunch's launches, K1's figures at
    the eval call)."""
    t_phase = time.perf_counter()
    test_data = os.path.join(d, "resume_test.jsonl")
    with open(data) as f, open(test_data, "w") as g:
        g.writelines(line for _, line in zip(range(PRE_B), f))
    runs = {n: os.path.join(d, f"resume_{n}") for n in ("run", "twin")}

    def argv(out, *extra):
        return ["--train_dataset", data, "--vocab_file", vocab,
                "--output_path", out, "--epochs", str(RESUME_EPOCHS),
                "--device", "cuda", "--steps_per_dispatch", str(RESUME_K),
                "--test_dataset", test_data, "--watch_interval", "1",
                "--log_freq", "1", "--save_interval", str(RESUME_EPOCHS),
                *extra]

    run_argv = argv(runs["run"], "--profile_dir",
                    os.path.join(runs["run"], "profile"))
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        first, fresh_startup, saves = _run_cli(pretrain_main.main, run_argv,
                                               RESUME_SIGNAL)
        marker = preempt.read_marker(runs["run"])
        check(first == [] and marker == {"epoch": 0, "batches_done": 6},
              f"preempted run: rows {first}, marker {marker}")
        mid = torch.load(os.path.join(runs["run"], "optim.0.bin"),
                         map_location="cpu", weights_only=True, mmap=True)
        check(mid["tx"]["count"] == 2 and mid["loader"]["epoch"] == 0,
              f"mid-epoch state: count {mid['tx']['count']}, loader "
              f"{mid['loader']['epoch']}")
        del mid
        mid_bytes = os.path.getsize(os.path.join(runs["run"], "optim.0.bin"))
        reset_counts()
        rows, startup, more = _run_cli(pretrain_main.main, run_argv)
        counts = read_counts()
        saves += more
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        twin, _, more = _run_cli(pretrain_main.main, argv(runs["twin"]))
        saves += more
    finally:
        torch.use_deterministic_algorithms(deterministic)
    check(preempt.read_marker(runs["run"]) is None, "marker not consumed")
    check([(r["epoch"], r["micro_steps"]) for r in rows]
          == [(0, 2), (1, 8)], f"relaunch rows {rows}")
    _same_files(runs["run"], runs["twin"], ("model.1.bin", "optim.1.bin"))
    evals = [{k: v for k, v in r.items() if k.startswith("eval_avg")}
             for r in rows]
    check(evals == [{k: v for k, v in r.items() if k.startswith("eval_avg")}
                    for r in twin], "eval rows differ from the twin's")
    micro = 2 + 8
    want = {"K1": 12 * micro + 12 * RESUME_EPOCHS, "K2": 12 * micro,
            "K3": 0, "K4": 0}
    check(counts == want and all(r["eval_batches"] == 1 for r in rows),
          f"relaunch launches {counts} != {want}")
    with open(os.path.join(runs["run"], "profile",
                           pretrain_main.TRACE_FILE)) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    kernels = sorted(n for n in names if "attn_" in n and "kernel" in n)
    check(any("attn_fwd" in n for n in kernels)
          and any("attn_bwd" in n for n in kernels),
          f"the trace holds no attention kernels: {kernels}")
    with open(os.path.join(runs["run"], pretrain_main.WATCH_FILE)) as f:
        watch = [json.loads(line) for line in f]
    # 2 dispatches logged before the stop, then 1 + 4 after the relaunch
    check(len(watch) == 2 + 1 + 4 and all(np.isfinite(r["watch/param_norm"])
                                          for r in watch),
          f"watch rows {len(watch)}")
    parity = _eval_parity(runs["run"], test_data, vocab, device)
    emit({"phase": "resume", "epochs": RESUME_EPOCHS, "k": RESUME_K,
          "batches_per_epoch": MICRO_STEPS, "accumulation": 4,
          "marker": marker, "deterministic_algorithms": True,
          "final_files_bit_equal_to_twin": True, "eval_rows_equal": True,
          "eval_rows": evals, "relaunch_launches": counts,
          "k1_per_eval_batch": 12, "trace_kernels": kernels,
          "optim_bytes": {"mid_accumulation": mid_bytes, "end_of_epoch":
                          os.path.getsize(os.path.join(runs["run"],
                                                       "optim.1.bin"))},
          "model_bytes": os.path.getsize(os.path.join(runs["run"],
                                                      "model.1.bin")),
          "save_s": saves, "eval_s_per_batch_cli": [r["eval_time_s"]
                                                    for r in rows],
          "startup_s": {"fresh": fresh_startup, "relaunch": startup},
          "peak_mem_gib": peak, "eval_parity": parity,
          "wall_s": time.perf_counter() - t_phase})
    return counts, parity["k1"]


def phase_resume_ft(ft_argv: list, d: str, device) -> dict:
    """The finetune CLI at its defaults with {"fused_ln": true} and
    --steps_per_dispatch 4 for 2 epochs of 8 batches, under PyTorch's
    deterministic algorithms: a SIGTERM sent as epoch 0's first group is
    handed out stops it after that dispatch (marker 0 / 4); the relaunch
    re-enters epoch 0 at batch 4 and ends with model.1.bin and optim.1.bin
    equal bit for bit to an uninterrupted run's; one more relaunch, no
    marker left, resumes by scan at epoch 2 and trains nothing.  Returns
    the first relaunch's launches."""
    t_phase = time.perf_counter()
    runs = {n: os.path.join(d, f"resume_ft_{n}") for n in ("run", "twin")}

    def argv(out):
        return ft_argv + ["--steps_per_dispatch", "4", "--num_train_epochs",
                          "2", "--output_dir", out]

    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        with _SignalAtBatch(finetune_main) as sig:
            first, _, saves = _run_cli(finetune_main.main,
                                       argv(runs["run"]))
        marker = preempt.read_marker(runs["run"])
        check(first["epochs"] == [] and sig.after == 1
              and marker == {"epoch": 0, "batches_done": 4},
              f"preempted finetune: {first}, marker {marker}")
        reset_counts()
        t0 = time.perf_counter()
        rows = finetune_main.main(argv(runs["run"]))["epochs"]
        relaunch_s = time.perf_counter() - t0
        counts = read_counts()
        finetune_main.main(argv(runs["twin"]))
    finally:
        torch.use_deterministic_algorithms(deterministic)
    check([(r["epoch"], r["micro_steps"]) for r in rows]
          == [(0, 4), (1, FT_MICRO_STEPS)], f"relaunch rows {rows}")
    micro = 4 + FT_MICRO_STEPS
    check(counts == {c: v * micro for c, v in KERNEL_COUNTS.items()},
          f"finetune relaunch launches {counts}")
    _same_files(runs["run"], runs["twin"], ("model.1.bin", "optim.1.bin"))
    # no marker left: the scan resumes at epoch 2, past the last one
    scan = finetune_main.main(argv(runs["run"]))["epochs"]
    with open(os.path.join(runs["run"], "training.log")) as f:
        resumed = f.read().count("resumed from epoch 1")
    check(scan == [] and resumed == 1, f"resume by scan: {scan}")
    emit({"phase": "resume-ft", "k": 4, "marker": marker,
          "deterministic_algorithms": True,
          "final_files_bit_equal_to_twin": True,
          "resumed_by_scan_at_epoch": 2, "relaunch_launches": counts,
          "optim_bytes": os.path.getsize(os.path.join(runs["run"],
                                                      "optim.1.bin")),
          "model_bytes": os.path.getsize(os.path.join(runs["run"],
                                                      "model.1.bin")),
          "relaunch_s": relaunch_s,
          "wall_s": time.perf_counter() - t_phase})
    return counts


def phase_preempt_clf(d: str, vocab: str, clf_data: str, device) -> None:
    """The classification CLI at its defaults (batch 56, the trunk
    trained): a SIGTERM sent as the first batch is handed out is read by
    the poll after that batch (within preempt.POLL_EVERY batches); the CLI
    writes model.0.bin and returns with no epoch done; the file holds the
    in-memory weights, tensor by tensor."""
    t_phase = time.perf_counter()
    savedir = os.path.join(d, "clf_preempt")
    argv = _clf_argv(d, vocab, clf_data) + ["--savedir", savedir,
                                            "--do_test", "false"]
    states = []
    init = classify.init_state
    classify.init_state = lambda *a, **kw: states.append(
        init(*a, **kw)) or states[-1]
    try:
        with _SignalAtBatch(classification_main) as sig:
            out = classification_main.main(argv)
    finally:
        classify.init_state = init
    path = os.path.join(savedir, "clf", "model.0.bin")
    check(out["epochs"] == [] and os.path.exists(path)
          and 1 <= sig.after <= preempt.POLL_EVERY,
          f"classification preemption: {out['epochs']}, {sig.after} "
          f"batches after the signal")
    saved = torch.load(path, map_location="cpu", weights_only=True,
                       mmap=True)
    own = states[0].model.state_dict()
    check(saved.keys() == own.keys() and all(
        torch.equal(saved[k], v.cpu()) for k, v in own.items()),
        "model.0.bin differs from the in-memory weights")
    emit({"phase": "preempt-clf", "batches_after_signal": sig.after,
          "poll_every_limit": preempt.POLL_EVERY, "file_bytes":
          os.path.getsize(path), "loads_equal_to_memory": True,
          "wall_s": time.perf_counter() - t_phase})
    del states, saved, own
    torch.cuda.empty_cache()


def _tokenizer_texts(data: str) -> list:
    """The train records' reports, each also upper-cased with punctuation
    (lower-casing and the punctuation split), and the cases of the
    exact-fallback paths: non-ASCII text, a literal special token, a NUL
    byte, more wordpieces than the library's buffer."""
    with open(data) as f:
        reports = [json.loads(line)["text"] for line in f]
    edges = ["tok7 café tok9", "tok1 [SEP] tok2", "tok3\x00tok4",
             "tok5 " * (native_tokenizer.NativeBertTokenizer.MAX_IDS + 8),
             "a" * 150 + " tok6", ""]
    return (reports + [r.upper().replace(" ", ", ", 3) + "." for r in
                       reports[:32]] + edges)


def _loader_ms(dataset, workers: int) -> float:
    """Host ms per batch of PRE_B of ``BatchLoader`` over ``dataset``, the
    pretrain CLI's worker threads, one epoch."""
    loader = BatchLoader(dataset, PRE_B, shuffle=True, seed=SEED,
                         workers=workers)
    t0 = time.perf_counter()
    n = sum(1 for _ in loader)
    seconds = time.perf_counter() - t0
    loader.close()
    return seconds / n * 1e3


def phase_tokenizer(data: str, vocab: str) -> None:
    """The native wordpiece tokenizer on this host: ``make_tokenizer`` (what
    the pretrain, finetune, classification and retrieval CLIs call)
    returns it with its library loaded; its ids equal the Python
    tokenizer's on every report of the train records, on 32 of them
    upper-cased with punctuation and on the fallback cases, with and
    without the unused-token remap; the host ms of tokenizing the 288
    reports both ways; then the pretrain loader's host ms per batch of 36
    (4 threads: PNG decode, tokenization, masking) with each tokenizer, in
    turns python, native, native, python."""
    texts = _tokenizer_texts(data)
    for remap in (False, True):
        native = make_tokenizer(vocab, remap_unused=remap)
        check(isinstance(native, native_tokenizer.NativeBertTokenizer)
              and native.native_available,
              "make_tokenizer did not return the native tokenizer")
        python = BertTokenizer.from_vocab_file(vocab, remap_unused=remap)
        for t in texts:
            check(native.tokenize_to_ids(t) == python.tokenize_to_ids(t),
                  f"native ids differ from Python's on {t[:60]!r}")
    reports = texts[:TRAIN_RECORDS]
    times = {}
    for name, tok in (("python", python), ("native", native)):
        t0 = time.perf_counter()
        for t in reports:
            tok.tokenize_to_ids(t)
        times[name] = (time.perf_counter() - t0) * 1e3
    cfg = PretrainConfig()
    loaders = {name: [] for name in ("python", "native")}
    for name in ("python", "native", "native", "python"):
        tok = (BertTokenizer.from_vocab_file(vocab, remap_unused=False)
               if name == "python" else make_tokenizer(vocab))
        loaders[name].append(_loader_ms(
            CXRPretrainDataset(data, tok, cfg, seed=SEED), cfg.num_workers))
    emit({"phase": "tokenizer", "native_available": True,
          "texts_checked": 2 * len(texts),
          "reports": len(reports),
          "tokenize_ms": times,
          "tokenize_speedup": times["python"] / times["native"],
          "loader_workers": cfg.num_workers,
          "loader_ms_per_batch": loaders,
          "loader_batch": PRE_B})


def _vit_shape_attn(device, gen) -> dict:
    """K1/K2 at the ViT pretrain call (B = 36, L = 256 + 253 + 3 = 512,
    BAR, img_block 258, text lengths 1..254) against their plain versions
    in f32 and bf16 at rates 0 and 0.1 (_attn_errs); the skipped tile
    pairs read back from the kernels and equal to the predicate; timed at
    the training call (bf16, rate 0.1; _attn_times).  Returns the
    kernels-line entries."""
    bar = int(MaskVariant.BAR)
    worst: dict = {}
    for dtype in (torch.float32, torch.bfloat16):
        for rate in (0.0, 0.1):
            q, k, v, do, spec = _attn_inputs(
                device, gen, PRE_B, VIT_L, VIT_IMG_BLOCK, fa.FAMILY_PRETRAIN,
                bar, dtype)
            kw = dict(img_block=VIT_IMG_BLOCK, l_real=VIT_L,
                      family=fa.FAMILY_PRETRAIN, rate=rate, seed=12)
            errs, tol = _attn_errs(q, k, v, do, spec, kw,
                                   f"vit shape {dtype} rate {rate}")
            _worst(worst, f"{str(dtype)[6:]}/rate{rate}", errs, tol)
            del q, k, v, do
    q, k, v, do, spec = _attn_inputs(device, gen, PRE_B, VIT_L,
                                     VIT_IMG_BLOCK, fa.FAMILY_PRETRAIN, bar,
                                     torch.bfloat16)
    kw = dict(img_block=VIT_IMG_BLOCK, l_real=VIT_L,
              family=fa.FAMILY_PRETRAIN, rate=0.1, seed=13)
    errs, _ = _attn_errs(q, k, v, do, spec, kw, "vit shape timed call")
    want = masks.tile_skip_grid(fa.FAMILY_PRETRAIN, spec, VIT_IMG_BLOCK,
                                VIT_L, VIT_L, fa.TILE)[:, None].to(device)
    read = fa.skipped_tiles(q, k, v, do, spec, img_block=VIT_IMG_BLOCK,
                            l_real=VIT_L, family=fa.FAMILY_PRETRAIN)
    for name, got in read.items():
        check(torch.equal(got, want.expand_as(got)),
              f"vit shape: {name} kernel skipped {int(got.sum())} tile "
              f"pairs, the predicate {int(want.sum()) * HEADS}")
    skipped = read["fwd"].float().mean().item()
    t = _attn_times(q, k, v, do, spec, kw)
    emit({"phase": "pretrain-vit", "timed": f"K1/K2 B={PRE_B} L={VIT_L} "
                                            "12x64 bf16 BAR rate 0.1", **t,
          "cases": 4, "max_abs_err": worst, "skipped_tile_pairs": skipped,
          "skips_read_back_equal_predicate": True})
    g_err = max(errs[n] for n in ("dq", "dk", "dv"))
    return {kid: {"max_abs_err": err, "ms": t[f"{n}_ms"],
                  "plain_ms": t[f"{n}_plain_ms"],
                  "bound_ms": t[f"{n}_bound_ms"],
                  "bound_by": t[f"{n}_bound_by"],
                  "library_ms": t[f"{n}_library_ms"],
                  "skipped_tile_pairs": skipped}
            for kid, n, err in (("K1", "k1", errs["o"]),
                                ("K2", "k2", g_err))}


def _vit_shape_ln(device, gen) -> dict:
    """K3/K4 at the ViT pretrain call (R = 36 x 512 = 18432, H 768, LN eps
    1e-12) against their plain versions (K4 also against autograd) in f32
    at rate 0 and bf16 at rate 0.1, timed at the latter (_ln_times).
    Returns the kernels-line entries."""
    rows = PRE_B * VIT_L
    for dtype, rate in ((torch.float32, 0.0), (torch.bfloat16, 0.1)):
        x, res, gamma, beta, dy = _ln_inputs(device, gen, rows, H, dtype)
        kw = dict(rate=rate, eps=1e-12, seed=80)
        what = f"vit shape {str(dtype)[6:]} rate {rate}"
        errs = _k4_errs(x, res, gamma, beta, dy, kw, what)
        y_want = fused_ln.fused_dropout_add_ln_plain(x, res, gamma, beta,
                                                     **kw)
        errs["k3_y"] = max_err(
            fused_ln.fused_ln_fwd(x, res, gamma, beta, **kw), y_want,
            1e-5 if dtype == torch.float32 else bf16_tol(y_want),
            f"K3 {what}")
    t = _ln_times(x, res, gamma, beta, dy, kw)
    emit({"phase": "pretrain-vit", "timed": f"K3/K4 R={rows} H={H} bf16 "
                                            "rate 0.1", "rows": rows,
          "max_abs_err": errs, **t})
    return {kid: {"max_abs_err": err, "ms": t[f"{n}_ms"],
                  "plain_ms": t[f"{n}_plain_ms"],
                  "bound_ms": t[f"{n}_bound_ms"],
                  "bound_by": t[f"{n}_bound_by"],
                  "library_ms": t[f"{n}_library_ms"], "rows": rows}
            for kid, n, err in (("K3", "k3", errs["k3_y"]),
                                ("K4", "k4", max(errs["dx"],
                                                 errs["dres"])))}


class _Warnings(logging.Handler):
    """The warnings the port logs (the ``medvill_torch`` logger), read from
    the root logger."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages: list = []

    def emit(self, record) -> None:
        if record.name.startswith("medvill_torch"):
            self.messages.append(record.getMessage())


def _vit_argv(out: str, data: str, vocab: str, k: int) -> list:
    """The pretrain CLI's arguments under ``--img_encoder ViT
    --num_image_embeds 256``, else its defaults: one epoch of the train
    records at ``--steps_per_dispatch k``."""
    return ["--train_dataset", data, "--vocab_file", vocab,
            "--output_path", out, "--epochs", "1", "--device", "cuda",
            "--img_encoder", "ViT", "--num_image_embeds", str(VIT_N),
            "--steps_per_dispatch", str(k), "--log_freq", "4"]


def _vit_cli(d: str, data: str, vocab: str, k: int) -> tuple:
    """The pretrain CLI at ``_vit_argv``: (its epoch row, launches, peak
    GiB, the warnings it logged, the tokenizer it built)."""
    out = os.path.join(d, f"pretrain_vit_k{k}")
    argv = _vit_argv(out, data, vocab, k)
    built = []
    real = pretrain_main.make_tokenizer

    def make(*a, **kw):
        built.append(real(*a, **kw))
        return built[-1]

    warnings = _Warnings()
    logging.getLogger().addHandler(warnings)
    pretrain_main.make_tokenizer = make
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    try:
        rows = pretrain_main.main(argv)
    finally:
        pretrain_main.make_tokenizer = real
        logging.getLogger().removeHandler(warnings)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    row = rows[0]
    check(row["micro_steps"] == MICRO_STEPS, f"vit k={k} micro steps {row}")
    check(all(np.isfinite(row[n]) for n in ("avg_loss", "avg_mlm_loss",
                                             "avg_itm_loss")),
          f"vit k={k}: non-finite losses {row}")
    model = pretrain_lib.build_model(pretrain_main.config_from_args(
        pretrain_main.build_parser().parse_args(argv)))
    check(load_cxrbert_checkpoint(model, os.path.join(out, "model.0.bin"))
          == [], f"vit k={k}: model.0.bin does not load strictly")
    check("enc.img_encoder.patch_to_embedding.weight" in model.state_dict(),
          "the ViT model has no patch embedding")
    shutil.rmtree(out)
    return row, counts, peak, warnings.messages, built


def phase_pretrain_vit(d: str, data: str, vocab: str, device) -> tuple:
    """The ViT image encoder at full width (BERT-base, 512 px, patch 32, so
    256 image tokens, seq_len 253, L = 512, BAR, batch 36, accumulation
    4): the pretrain CLI's entry point with --img_encoder ViT
    --num_image_embeds 256 over the train records (8 micro-steps), eagerly
    and at --steps_per_dispatch 4 (two graphed dispatches): finite losses,
    exactly 12 K1 and 12 K2 launches per micro-step (replays counted), no
    warning logged (no frozen trunk), the native tokenizer built with its
    library loaded, model.0.bin loading strictly with the patch embedding;
    pairs/s, ms per micro-step and peak memory.  Then K1/K2 at the call
    (_vit_shape_attn) and K3/K4 at R = 18432 (_vit_shape_ln); then the
    trainer with fused_ln on, 4 micro-steps on one repeated batch at
    accumulation 1 from generators of one seed: exactly 12/12/24/24 K1-K4
    launches per micro-step, the loss falls; and the steady ms per
    micro-step on a resident batch at the CLI's accumulation of 4, eager
    against graphed (k = 4) in turns (_graph_timing).  Returns (the CLI
    runs' launches, the trainer's, the kernels-line
    entries)."""
    t_phase = time.perf_counter()
    cli = {}
    cli_counts = {n: 0 for n in ("K1", "K2", "K3", "K4")}
    for k in (1, 4):
        row, counts, peak, warnings, built = _vit_cli(d, data, vocab, k)
        want = {"K1": 12 * MICRO_STEPS, "K2": 12 * MICRO_STEPS, "K3": 0,
                "K4": 0}
        check(counts == want, f"vit k={k} launches {counts} != {want}")
        check(warnings == [], f"vit k={k} logged warnings: {warnings}")
        check(len(built) == 1 and isinstance(
            built[0], native_tokenizer.NativeBertTokenizer)
            and built[0].native_available,
            f"vit k={k}: the CLI did not build the native tokenizer")
        for n, c in counts.items():
            cli_counts[n] += c
        cli[f"k{k}"] = {
            "pairs_per_s": row["pairs_per_s"],
            "ms_per_micro_step": row["epoch_time_s"] / MICRO_STEPS * 1e3,
            "epoch_s": row["epoch_time_s"], "peak_mem_gib": peak,
            "avg_loss": row["avg_loss"], "launches": counts}
    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    entries = _vit_shape_attn(device, gen)
    entries.update(_vit_shape_ln(device, gen))
    cfg = pretrain_main.config_from_args(pretrain_main.build_parser(
        ).parse_args(_vit_argv(d, data, vocab, 1)))
    cfg = dataclasses.replace(
        cfg, bert=dataclasses.replace(cfg.bert, fused_ln=True),
        gradient_accumulation_steps=1)
    batch = _train_batch(data, vocab, cfg, device, PRE_B)
    check(tuple(batch["txt_labels"].shape) == (PRE_B, VIT_L),
          f"vit batch shape {tuple(batch['txt_labels'].shape)}")
    state = pretrain_lib.init_state(cfg, seed=SEED, device=device)
    step = pretrain_lib.make_train_step(cfg)
    reset_counts()
    losses = [step(state, batch, torch.Generator().manual_seed(SEED))
              ["loss"].item() for _ in range(4)]
    fused_counts = read_counts()
    del state
    want = {n: c * 4 for n, c in KERNEL_COUNTS.items()}
    check(fused_counts == want,
          f"vit fused launches {fused_counts} != {want}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"vit fused loss did not fall: {losses}")
    c4 = dataclasses.replace(cfg, gradient_accumulation_steps=4)
    timing = _graph_timing(
        lambda: pretrain_lib.init_state(c4, seed=SEED, device=device),
        lambda: pretrain_lib.make_train_step(c4), batch, 4, profile=False)
    emit({"phase": "pretrain-vit", "batch": PRE_B, "seq": VIT_L,
          "image_tokens": VIT_N, "micro_steps": MICRO_STEPS, "cli": cli,
          "native_tokenizer": True, "fused_losses": losses,
          "fused_launches_per_micro_step": {
              n: c / 4 for n, c in fused_counts.items()},
          "steady_fused": timing,
          "seconds": time.perf_counter() - t_phase})
    return cli_counts, fused_counts, entries

def _head_groups(t: torch.Tensor, n: int) -> list:
    """[B, L, heads, ...] cut into ``n`` contiguous groups of heads, as the
    model ranks of --model_parallel n hold them."""
    return [c.contiguous() for c in t.chunk(n, dim=2)]


def phase_tp_heads(device) -> dict:
    """K1/K2 on the local heads of --model_parallel 2 and 4 at the pretrain
    call (see the module docstring, phase 25).  Returns the kernels-line
    entries, {"K1": {"H6": ..., "H3": ...}, "K2": ...}."""
    t_phase = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(SEED + 6)
    bar = int(MaskVariant.BAR)
    out = {"K1": {}, "K2": {}}
    report = {}
    for mp in (2, 4):
        h = HEADS // mp
        worst: dict = {}
        for dtype in (torch.float32, torch.bfloat16):
            for rate in (0.0, 0.1):
                q, k, v, do, spec = _attn_inputs(
                    device, gen, PRE_B, PRE_L, PRE_IMG_BLOCK,
                    fa.FAMILY_PRETRAIN, bar, dtype, heads=h)
                kw = dict(img_block=PRE_IMG_BLOCK, l_real=PRE_L,
                          family=fa.FAMILY_PRETRAIN, rate=rate, seed=14)
                errs, tol = _attn_errs(q, k, v, do, spec, kw,
                                       f"H {h} {dtype} rate {rate}")
                _worst(worst, f"{str(dtype)[6:]}/rate{rate}", errs, tol)
                del q, k, v, do
        # rate 0: a head's tiles read only that head, so the groups'
        # launches concatenated are the H 12 launch
        q, k, v, do, spec = _attn_inputs(
            device, gen, PRE_B, PRE_L, PRE_IMG_BLOCK, fa.FAMILY_PRETRAIN,
            bar, torch.bfloat16)
        kw = dict(img_block=PRE_IMG_BLOCK, l_real=PRE_L,
                  family=fa.FAMILY_PRETRAIN, rate=0.0, seed=0)
        o, lse = fa.attn_fwd(q, k, v, spec, **kw)
        whole = (o, lse, *fa.attn_bwd(q, k, v, o, do, lse, spec, **kw))
        parts = []
        for qs, ks, vs, dos in zip(*(_head_groups(t, mp)
                                     for t in (q, k, v, do))):
            os_, lses = fa.attn_fwd(qs, ks, vs, spec, **kw)
            parts.append((os_, lses, *fa.attn_bwd(qs, ks, vs, os_, dos, lses,
                                                  spec, **kw)))
        for i, name in enumerate(("o", "lse", "dq", "dk", "dv")):
            dim = 1 if name == "lse" else 2  # lse is [B, heads, L]
            check(torch.equal(torch.cat([p[i] for p in parts], dim),
                              whole[i]),
                  f"H {h}: the {mp} groups' {name} differ from the H 12 "
                  "launch")
        del q, k, v, do, o, lse, whole, parts
        q, k, v, do, spec = _attn_inputs(
            device, gen, PRE_B, PRE_L, PRE_IMG_BLOCK, fa.FAMILY_PRETRAIN,
            bar, torch.bfloat16, heads=h)
        kw = dict(img_block=PRE_IMG_BLOCK, l_real=PRE_L,
                  family=fa.FAMILY_PRETRAIN, rate=0.1, seed=15)
        errs, _ = _attn_errs(q, k, v, do, spec, kw, f"H {h} timed call")
        t = _attn_times(q, k, v, do, spec, kw)
        del q, k, v, do
        g_err = max(errs[n] for n in ("dq", "dk", "dv"))
        for kid, n, err in (("K1", "k1", errs["o"]), ("K2", "k2", g_err)):
            out[kid][f"H{h}"] = {
                "max_abs_err": err, "ms": t[f"{n}_ms"],
                "plain_ms": t[f"{n}_plain_ms"],
                "bound_ms": t[f"{n}_bound_ms"],
                "bound_by": t[f"{n}_bound_by"],
                "library_ms": t[f"{n}_library_ms"]}
        report[f"H{h}"] = {"model_parallel": mp, "cases": 4,
                           "max_abs_err": worst, **t,
                           "groups_equal_h12_launch": True}
    emit({"phase": "tp-heads", "timed": f"K1/K2 B={PRE_B} L={PRE_L} "
                                        "Hx64 bf16 BAR rate 0.1",
          **report, "seconds": time.perf_counter() - t_phase})
    return out


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class _Launched:
    """A one-process launch's variables in the environment (WORLD_SIZE=1,
    RANK 0, this host), removed again on exit, with the process group
    destroyed and the layout forgotten."""

    def __enter__(self):
        self.env = dict(WORLD_SIZE="1", RANK="0", LOCAL_RANK="0",
                        MASTER_ADDR="localhost",
                        MASTER_PORT=str(_free_port()))
        os.environ.update(self.env)
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        for k in self.env:
            os.environ.pop(k, None)
        parallel.reset()
        if dist.is_initialized():
            dist.destroy_process_group()
        return False


def _dist1_cli(out: str, data: str, vocab: str, k: int, launched: bool):
    """The pretrain CLI with fused_ln on over the train records at
    --steps_per_dispatch k, with --zero1 true under a one-process launch:
    (its epoch row, launches, peak GiB)."""
    argv = ["--train_dataset", data, "--vocab_file", vocab,
            "--output_path", out, "--epochs", "1", "--device", "cuda",
            "--log_freq", "4", "--num_workers", "4",
            "--steps_per_dispatch", str(k)]
    if launched:
        argv += ["--zero1", "true"]
    real = pretrain_main.config_from_args

    def fused(args):
        cfg = real(args)
        return dataclasses.replace(
            cfg, bert=dataclasses.replace(cfg.bert, fused_ln=True))

    pretrain_main.config_from_args = fused
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    try:
        if launched:
            with _Launched():
                rows = pretrain_main.main(argv)
        else:
            rows = pretrain_main.main(argv)
    finally:
        pretrain_main.config_from_args = real
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    return rows[0], counts, peak


def _tx_equal(got: str, want: str) -> None:
    """optim.0.bin's optimizer state (moments, steps, host values) of two
    runs equal, tensor by tensor bit for bit."""
    a, b = (torch.load(os.path.join(d, "optim.0.bin"), map_location="cpu",
                       weights_only=True, mmap=True)["tx"]
            for d in (got, want))
    check(a["optimizer"] == b["optimizer"] and a["host"] == b["host"]
          and a["count"] == b["count"] and len(a["state"]) == len(b["state"]),
          "the optimizer states differ in kind or size")
    for i, (x, y) in enumerate(zip(a["state"], b["state"])):
        check(x.keys() == y.keys(), f"optimizer state {i}: other entries")
        for key in x:
            check(torch.equal(x[key], y[key]),
                  f"optimizer state {i}/{key} differs")


def phase_dist1(d: str, data: str, vocab: str, device) -> dict:
    """The pretrain CLI as a one-process NCCL launch (see the module
    docstring, phase 26).  Returns the launched runs' launches."""
    import torch.distributed as dist

    t_phase = time.perf_counter()
    runs = {}
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        for name, k, launched in (("plain", 1, False), ("nccl", 1, True),
                                  ("nccl-graphed", 4, True)):
            out = os.path.join(d, f"dist1_{name}")
            row, counts, peak = _dist1_cli(out, data, vocab, k, launched)
            want = {n: c * MICRO_STEPS for n, c in KERNEL_COUNTS.items()}
            check(counts == want, f"dist-1 {name} launches {counts}")
            check(row["micro_steps"] == MICRO_STEPS, f"dist-1 {name} {row}")
            runs[name] = {"dir": out, "row": row, "launches": counts,
                          "peak_mem_gib": peak,
                          "ms_per_micro_step": row["epoch_time_s"]
                          / MICRO_STEPS * 1e3}
            check(not dist.is_initialized(), "the process group outlived "
                  "its launch")
    finally:
        torch.use_deterministic_algorithms(deterministic)
    keys = [k for k in runs["plain"]["row"] if k.startswith("avg_")]
    for name in ("nccl", "nccl-graphed"):
        for key in keys:
            check(runs[name]["row"][key] == runs["plain"]["row"][key],
                  f"dist-1 {name} {key} {runs[name]['row'][key]} != "
                  f"{runs['plain']['row'][key]}")
        _same_files(runs[name]["dir"], runs["plain"]["dir"],
                    ("model.0.bin",))
        _tx_equal(runs[name]["dir"], runs["plain"]["dir"])
    launches = {n: runs["nccl"]["launches"][n]
                + runs["nccl-graphed"]["launches"][n] for n in KERNEL_COUNTS}
    # the steady step with and without the process group, one batch
    cfg = pretrain_main.config_from_args(pretrain_main.build_parser(
        ).parse_args(["--train_dataset", data, "--vocab_file", vocab]))
    cfg = dataclasses.replace(cfg, bert=dataclasses.replace(cfg.bert,
                                                            fused_ln=True))
    batch = _train_batch(data, vocab, cfg, device, PRE_B)
    steady = {}
    for name, launched in (("plain", False), ("nccl", True),
                           ("nccl2", True), ("plain2", False)):
        def make_state():
            state = pretrain_lib.init_state(cfg, seed=SEED, device=device)
            parallel.place(state, zero1=launched)
            return state

        torch.cuda.reset_peak_memory_stats()
        if launched:
            with _Launched():
                parallel.initialize(device)
                parallel.configure(1)
                timing = _graph_timing(
                    make_state, lambda: pretrain_lib.make_train_step(cfg),
                    batch, 4, profile=False, rounds=2)
        else:
            timing = _graph_timing(
                make_state, lambda: pretrain_lib.make_train_step(cfg),
                batch, 4, profile=False, rounds=2)
        timing["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        steady[name] = timing
    emit({"phase": "dist-1", "batch": PRE_B, "seq": PRE_L,
          "micro_steps": MICRO_STEPS, "zero1": True, "fused_ln": True,
          "cli": {n: {k: v for k, v in r.items() if k != "dir"}
                  for n, r in runs.items()},
          "equal_to_plain": ["avg_* metrics", "model.0.bin", "optim tx"],
          "steady": steady, "seconds": time.perf_counter() - t_phase})
    return launches


# a rank of the pretrain CLI under a launch (phase dist-2): argv from the
# spec, deterministic algorithms, dropout 0 when asked; its rows and
# kernel launches printed as the last line
_RANK_WORKER = """
import dataclasses, json, sys
import torch
torch.use_deterministic_algorithms(True)
from medvill_torch.cli import pretrain_main
from medvill_torch.ops import flash_attention as fa, fused_ln
spec = json.loads(sys.argv[1])
if spec["dropout0"]:
    real = pretrain_main.config_from_args
    def config(args):
        cfg = real(args)
        return dataclasses.replace(cfg, bert=dataclasses.replace(
            cfg.bert, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0))
    pretrain_main.config_from_args = config
# the peak from the first update on: the optimizer's state exists, as in
# every later step (before it, the first backward sets the run's peak)
from medvill_torch.train import optim
cuda, first = torch.cuda.is_available(), []
finish = optim.Accumulate.finish
def finish_and_mark(self, applied):
    finish(self, applied)
    if applied and cuda and not first:
        torch.cuda.synchronize()
        first.append(torch.cuda.max_memory_allocated() / 2 ** 30)
        torch.cuda.reset_peak_memory_stats()
optim.Accumulate.finish = finish_and_mark
rows = pretrain_main.main(spec["argv"])
print("RESULT " + json.dumps({"rows": rows, "launches": {
    "K1": fa.attn_fwd.launches, "K2": fa.attn_bwd.launches,
    "K3": fused_ln.fused_ln_fwd.launches,
    "K4": fused_ln.fused_ln_bwd.launches},
    "peak_gib": max(first + [torch.cuda.max_memory_allocated() / 2 ** 30])
    if cuda else None,
    "steady_peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30
    if cuda and first else None}), flush=True)
"""


def _ranks(argv: list, d: str, name: str, world: int, dropout0: bool = False,
           term_rank1_at: str = None) -> list:
    """``world`` ranks of the pretrain CLI (``_RANK_WORKER``), one per
    GPU, a launcher's variables in their environment (none at world 0: one
    process without torch.distributed); with ``term_rank1_at``, a SIGTERM
    to rank 1 alone when rank 0 logs that text.  Returns each rank's
    RESULT."""
    port = str(_free_port())
    procs, logs = [], []
    for r in range(max(world, 1)):
        env = {k: v for k, v in os.environ.items()
               if k not in parallel.ENV}
        if world:
            env.update(WORLD_SIZE=str(world), RANK=str(r),
                       LOCAL_RANK=str(r), MASTER_ADDR="localhost",
                       MASTER_PORT=port)
        log = os.path.join(d, f"{name}.rank{r}.log")
        logs.append(log)
        with open(log, "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _RANK_WORKER,
                 json.dumps({"argv": argv, "dropout0": dropout0})],
                env=env, stdout=f, stderr=subprocess.STDOUT))
    try:
        sent = term_rank1_at is None
        deadline = time.time() + 600
        while any(p.poll() is None for p in procs):
            check(time.time() < deadline, f"{name}: ranks still running")
            if not sent:
                with open(logs[0]) as f:
                    if term_rank1_at in f.read():
                        procs[1].send_signal(signal.SIGTERM)
                        sent = True
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    out = []
    for r, (p, log) in enumerate(zip(procs, logs)):
        with open(log) as f:
            text = f.read()
        check(p.returncode == 0, f"{name} rank {r} exited {p.returncode}: "
              f"{text[-3000:]}")
        check(sent, f"{name}: rank 0 never logged {term_rank1_at!r}")
        line = [x for x in text.splitlines() if x.startswith("RESULT ")][-1]
        out.append(json.loads(line[len("RESULT "):]))
    return out


def phase_dist2(d: str, data: str, vocab: str, device) -> dict:
    """Two ranks of the pretrain CLI at full width, one per GPU (NCCL;
    gloo with the CPU), under deterministic algorithms: (1) data
    parallelism with --zero1 true at k = 2 (per-rank batch 36, 2 epochs of
    2 dispatches), stopped by a SIGTERM to rank 1 alone when rank 0 logs
    its first dispatch: both ranks stop at the same boundary (one marker),
    and the relaunch ends with model.1.bin and optim.1.bin equal bit for
    bit to an uninterrupted two-rank run's; model.1.bin loads strictly in
    this process, whose eval of the test records equals the eval rank 0
    logged; (2) --model_parallel 2 (K1/K2 on 6 heads a rank) at dropout 0
    against one process: the epoch's losses within 1e-3 relative (bf16
    products summed in another order, the row-parallel partial sums
    all-reduced in bf16), 12 K1 and 12 K2 per micro-step on each rank,
    model.0.bin strict here; (3) each rank's peak memory over two epochs
    at k = 2 with and without --zero1 true, and from the first update on,
    where the moments are resident: lower with it.  Skipped, with
    a line saying so, on fewer than two GPUs.  Returns the ranks'
    launches."""
    if device.type == "cuda" and torch.cuda.device_count() < 2:
        emit({"phase": "dist-2", "skipped": True,
              "reason": f"{torch.cuda.device_count()} GPU: the two-rank "
                        "NCCL legs wait for a host with two GPUs (NCCL "
                        "refuses two ranks on one device)"})
        return {}
    t_phase = time.perf_counter()
    test_data = os.path.join(d, "dist2_test.jsonl")
    with open(data) as f, open(test_data, "w") as g:
        g.writelines(line for _, line in zip(range(PRE_B), f))

    def argv(out, *extra):
        return ["--train_dataset", data, "--vocab_file", vocab,
                "--output_path", out, "--device", device.type,
                "--num_workers", "4", "--log_freq", "1", *extra]

    dp = ("--epochs", "2", "--steps_per_dispatch", "2", "--zero1", "true",
          "--test_dataset", test_data)
    runs = {n: os.path.join(d, f"dist2_{n}") for n in ("twin", "stopped")}
    twin = _ranks(argv(runs["twin"], *dp), d, "twin", 2)
    first = _ranks(argv(runs["stopped"], *dp), d, "stopped", 2,
                   term_rank1_at="epoch 0 it 0 ")
    marker = preempt.read_marker(runs["stopped"])
    check(marker is not None and first[0]["rows"] == first[1]["rows"] == [],
          f"dist-2: not stopped mid-run: marker {marker}")
    resumed = _ranks(argv(runs["stopped"], *dp), d, "resumed", 2)
    _same_files(runs["stopped"], runs["twin"], ("model.1.bin",
                                                "optim.1.bin"))
    check(preempt.read_marker(runs["stopped"]) is None, "marker left")
    rows = twin[0]["rows"]
    check(len(rows) == 2 and all(np.isfinite(r["avg_loss"]) for r in rows),
          f"dist-2 rows {rows}")
    cfg = pretrain_main.config_from_args(pretrain_main.build_parser(
        ).parse_args(argv(runs["twin"])))
    model = pretrain_lib.build_model(cfg).to(device)
    check(load_cxrbert_checkpoint(model, os.path.join(
        runs["twin"], "model.1.bin")) == [], "dist-2 model.1.bin not strict")
    tok = BertTokenizer.from_vocab_file(vocab, remap_unused=False)
    test_ds = CXRPretrainDataset(test_data, tok, cfg, seed=cfg.seed + 1)
    test_ds.rng.seed(cfg.seed + 1)
    step = pretrain_lib.make_eval_step(cfg)
    losses = [step(model, pretrain_lib.to_device(b, device))["loss"].item()
              for b in BatchLoader(test_ds, cfg.batch_size, shuffle=False)]
    eval_here, eval_rank0 = float(np.mean(losses)), rows[1]["eval_avg_loss"]
    check(abs(eval_here - eval_rank0) <= 1e-5 * abs(eval_rank0),
          f"dist-2 eval here {eval_here} != rank 0's {eval_rank0}")
    del model
    # ZeRO-1's purpose: each rank's peak with and without it, k = 2, over
    # the run and from the first update on (the moments resident; the
    # second epoch captures the update's graph then)
    peaks = {}
    for name, extra in (("replicated", ()), ("zero1", ("--zero1", "true"))):
        res = _ranks(argv(os.path.join(d, f"dist2_mem_{name}"), "--epochs",
                          "2", "--steps_per_dispatch", "2", *extra), d,
                     f"mem_{name}", 2)
        peaks[name] = {k: [r[k] for r in res]
                       for k in ("peak_gib", "steady_peak_gib")}
    check(device.type != "cuda" or all(z < r for z, r in zip(
        peaks["zero1"]["steady_peak_gib"],
        peaks["replicated"]["steady_peak_gib"])),
        f"dist-2: ZeRO-1 saves no memory: peaks {peaks}")
    tp_args = ("--epochs", "1", "--model_parallel", "2")
    one = _ranks(argv(os.path.join(d, "dist2_one"), "--epochs", "1"), d,
                 "one", 0, dropout0=True)
    tp = _ranks(argv(os.path.join(d, "dist2_tp"), *tp_args), d, "tp", 2,
                dropout0=True)
    for key in ("avg_loss", "avg_mlm_loss", "avg_itm_loss"):
        a, b = tp[0]["rows"][0][key], one[0]["rows"][0][key]
        check(abs(a - b) <= 1e-3 * abs(b), f"dist-2 tp {key} {a} vs {b}")
    for r in tp:
        want = {"K1": 12 * MICRO_STEPS, "K2": 12 * MICRO_STEPS, "K3": 0,
                "K4": 0}
        check(r["launches"] == want, f"dist-2 tp launches {r['launches']}")
    model = pretrain_lib.build_model(cfg)
    check(load_cxrbert_checkpoint(model, os.path.join(
        d, "dist2_tp", "model.0.bin")) == [], "dist-2 tp model.0.bin")
    del model
    emit({"phase": "dist-2", "world": 2, "marker": marker,
          "resumed_equal": ["model.1.bin", "optim.1.bin"],
          "eval_loss": {"rank0": eval_rank0, "one_process": eval_here},
          "dp_rows": rows, "peak_gib_per_rank": peaks, "tp_losses": {
              k: [tp[0]["rows"][0][k], one[0]["rows"][0][k]]
              for k in ("avg_loss", "avg_mlm_loss", "avg_itm_loss")},
          "tp_pairs_per_s": tp[0]["rows"][0]["pairs_per_s"],
          "one_pairs_per_s": one[0]["rows"][0]["pairs_per_s"],
          "seconds": time.perf_counter() - t_phase})
    launches = {n: 0 for n in KERNEL_COUNTS}
    for res in (*twin, *resumed, *tp):
        for n in launches:
            launches[n] += res["launches"][n]
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this script runs only "
              "on a GPU host", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"phase": "env", "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0)})
    ptxas = phase_build()
    k3_shapes = phase_kernel(device)
    entries = phase_kernel_attn(device)
    entries.update(phase_kernel_ln_bwd(device, ptxas))
    with tempfile.TemporaryDirectory(prefix="medvill_smoke_") as d:
        argv = _write_fixture(d)
        reset_counts()
        serve_launches = phase_serve(argv)
        phase_parity(argv, device)
        vocab = argv[argv.index("--vocab_file") + 1]
        train_counts, data = phase_train(d, vocab)
        fused_counts = phase_train_fused(data, vocab, device)
        phase_train_parity(data, vocab, device)
        ft_argv = _finetune_argv(d, vocab, data)
        finetune_counts = phase_finetune(ft_argv, device)
        phase_finetune_steps(ft_argv, device)
        phase_finetune_parity(ft_argv, device)
        decode_counts = phase_decode(ft_argv, d, device)
        classify_counts = phase_classify(d, vocab, device)
        clf_fused_counts = phase_clf_steps(os.path.join(d, "clf_data"),
                                           vocab, device)
        retrieve_counts, ret_paths = phase_retrieve(d, vocab, device)
        phase_retr_steps(ret_paths, vocab, device)
        phase_retrieve_cnn(d, vocab, ret_paths, device)
        graph_counts = phase_graph_steps(
            ft_argv, data, vocab, os.path.join(d, "clf_data"), ret_paths, d,
            device)
        resume_counts, eval_k1 = phase_resume(d, data, vocab, device)
        resume_ft_counts = phase_resume_ft(ft_argv, d, device)
        phase_preempt_clf(d, vocab, os.path.join(d, "clf_data"), device)
        phase_tokenizer(data, vocab)
        vit_counts, vit_fused_counts, vit_entries = phase_pretrain_vit(
            d, data, vocab, device)
        tp_entries = phase_tp_heads(device)
        dist1_counts = phase_dist1(d, data, vocab, device)
        dist2_counts = phase_dist2(d, data, vocab, device)
    paths = {"serve": {"K3": serve_launches}, "train": train_counts,
             "train-fused": fused_counts, "finetune": finetune_counts,
             "decode": decode_counts, "classify": classify_counts,
             "classify-fused": clf_fused_counts,
             "retrieve": {k: retrieve_counts[k] for k in ("K1", "K2")},
             "finetune-graphs": graph_counts,
             "resume": {k: resume_counts[k] for k in ("K1", "K2")},
             "resume-ft": resume_ft_counts,
             "pretrain-vit": {k: vit_counts[k] for k in ("K1", "K2")},
             "pretrain-vit-fused": vit_fused_counts,
             "dist-1": dist1_counts}
    if dist2_counts:
        paths["dist-2"] = dist2_counts
    sources = {"K1": ("flash_attention_fwd", "flash_attention.cu",
                      "medvill_tpu/ops/flash_attention.py:95"),
               "K2": ("flash_attention_bwd", "flash_attention.cu",
                      "medvill_tpu/ops/flash_attention.py:136"),
               "K3": ("fused_dropout_add_ln", "fused_ln.cu",
                      "medvill_tpu/ops/fused_ln.py:57"),
               "K4": ("fused_dropout_add_ln_bwd", "fused_ln.cu",
                      "medvill_tpu/ops/fused_ln.py:72")}
    kernels = []
    for kid, (name, src, replaces) in sources.items():
        by_path = {p: c[kid] for p, c in paths.items() if kid in c}
        check(sum(by_path.values()) > 0, f"{kid} never ran on a main path")
        kernels.append({"id": kid, "name": name, "route": "cuda",
                        "source": f"medvill_torch/ops/csrc/{src}",
                        "replaces": replaces,
                        "launches": sum(by_path.values()),
                        "launches_by_path": by_path, **entries[kid]})
    kernels[0]["eval_shape"] = eval_k1
    for entry in kernels:
        entry["vit_shape"] = vit_entries[entry["id"]]
        if entry["id"] in tp_entries:
            entry["tp_shape"] = tp_entries[entry["id"]]
    for key, shape in (("serve_shape", "prefill"),
                       ("beam_window_shape", "beam-window")):
        rec = k3_shapes[shape]
        kernels[2][key] = {
            "rows": rec["rows"], "max_abs_err": rec["max_abs_err"],
            "ms": rec["kernel_ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "library_ms": rec["library_ms"]}
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
