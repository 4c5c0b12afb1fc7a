"""Where the time goes in the port's training step on one NVIDIA GPU:
pretraining (the default), report-generation finetuning, MMBT
classification or image-text retrieval.

    python tools/torch_pretrain_profile.py \
        [--mode finetune|classify|retrieve] [--fused_ln] [--steps 8] \
        [--table out/torch_pretrain_profile.txt]

``--mode pretrain``: the configuration of chip_smoke.py's ``train`` phase:
PretrainConfig defaults (BERT-base, ResNet-50 random-pixel encoder at 512 px
with 180 of 256 fibers, seq_len 253 so L = 436, BAR, batch 36, accumulation
4, AdamW lr 1e-5).  ``--mode finetune``: the finetune CLI's defaults
(BERT-base VLP, ResNet-50 at 512 px with all 256 fibers, L = 512, s2s
masks, batch 4, max_pred 128, label smoothing 0.1, BertAdam lr 3e-5 at
every micro-step).  ``--mode classify``: the classification CLI's defaults
(BERT-base, the ResNet-50 trunk trained at 512 px with 256 fibers, FULL
over L = 514, batch 56, weighted BCE over 14 labels, BertAdam lr 1e-4) on
chip_smoke.py's classification fixture (112 train records over 8 shared
512-px PNGs).  ``--mode retrieve``: the retrieval CLI's defaults (CXRBERT,
the frozen ResNet-50 trunk at 512 px with 180 random-pixel embeds, FULL
over L = 436, 70 label-conditioned pairs = 140 rows, AdamW lr 1e-5) on
chip_smoke.py's retrieval fixture (140 train records).  Random weights
from seed 0, bf16 compute.  It writes
chip_smoke.py's synthetic vocabulary and records (288 records over 8 shared
512-px PNGs, or the classification fixture), then:

- loader: the host time per batch of ``BatchLoader`` (the CLI's worker
  threads: 4 for pretraining, 1 for finetuning and classification; PNG
  decode, tokenization, masking), or of the retrieval CLI's pair batches
  (one thread, both rows of each pair), alone;
- step: the host-clock time per micro-step of the train step on one
  device-resident batch, ``--steps`` micro-steps after two of warmup,
  ending in a sync;
- profile: ``--steps`` micro-steps under torch.profiler: device busy time,
  idle share (1 - busy / traced wall), kernel launches per micro-step, the
  device time by kind (K1, K2, K3, K4, GEMM, convolution, optimizer
  (multi-tensor kernels), elementwise/reduction, other), the span of the
  optimizer's step on the device timeline (its ``Optimizer.step`` range
  from first kernel to last, gaps included; a span, not busy time, and not
  in the other sums) and the top kernels.

One JSON line per result; ``--table`` also writes the operator table to
that file.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from medvill_torch.cli import finetune_main, retrieval_main  # noqa: E402
from medvill_torch.config import BertConfig, PretrainConfig  # noqa: E402
from medvill_torch.data.pretrain import (BatchLoader,  # noqa: E402
                                         CXRPretrainDataset)
from medvill_torch.data.retrieval import (CXRRetrievalDataset,  # noqa: E402
                                          collate_pairs)
from medvill_torch.data.seq2seq import Img2TxtDataset  # noqa: E402
from medvill_torch.data.tokenization import BertTokenizer  # noqa: E402
from medvill_torch.train import classify  # noqa: E402
from medvill_torch.train import finetune as finetune_lib  # noqa: E402
from medvill_torch.train import pretrain as pretrain_lib  # noqa: E402
from medvill_torch.train import retrieve  # noqa: E402

# the device-timeline spans of record_function ranges, left out of the
# kernel sums
ANNOTATIONS = ("Optimizer.step#", "ProfilerStep#")
# kernel-name substrings, first match wins
KINDS = (("K1", ("attn_fwd_",)),
         ("K2", ("attn_bwd_",)),
         ("K3", ("fused_ln_fwd_kernel",)),
         ("K4", ("fused_ln_bwd_kernel",)),
         ("optimizer", ("multi_tensor", "adam")),
         ("convolution", ("conv", "cudnn", "implicit_gemm", "xmma_fprop",
                          "winograd")),
         ("gemm", ("gemm", "cutlass", "cublas", "sm90_xmma", "nvjet")),
         ("elementwise/reduction", ("elementwise", "reduce", "vectorized",
                                    "softmax", "norm", "index", "gather",
                                    "scatter", "copy", "fill", "cat",
                                    "sort", "where")))


def _attr(evt, *names):
    for n in names:
        if hasattr(evt, n):
            return getattr(evt, n)
    return 0.0


def _kind(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def _pair_batches(ds, pairs: int) -> list:
    """The retrieval CLI's batches: ``pairs`` (positive, negative) pairs
    collated, positives then negatives."""
    return [collate_pairs([ds[j] for j in range(i * pairs, (i + 1) * pairs)])
            for i in range(len(ds) // pairs)]


def _setup(mode: str, fused_ln: bool, data: str, vocab: str, device):
    """(dataset, batch size, loader workers, train state, train step,
    what one example is called) of ``mode``."""
    if mode == "retrieve":
        cfg = retrieval_main.config_from_args(
            retrieval_main.build_parser().parse_args(["--vocab_file", vocab]))
        cfg = dataclasses.replace(cfg, bert=dataclasses.replace(
            cfg.bert, fused_ln=fused_ln))
        tok = BertTokenizer.from_vocab_file(vocab, remap_unused=False)
        return (CXRRetrievalDataset(data, tok, cfg, is_train=True, seed=0),
                cfg.batch_size, 1, retrieve.init_state(cfg, seed=0,
                                                       device=device),
                retrieve.make_train_step(cfg), "examples")
    if mode == "classify":
        cfg, ds, pw, cls_id, sep_id = chip_smoke._clf_setup(data, vocab)
        cfg = dataclasses.replace(cfg, bert=dataclasses.replace(
            cfg.bert, fused_ln=fused_ln))
        return (ds, cfg.batch_size, 1, classify.init_state(
            cfg, len(cfg.labels), t_total=1000, seed=0, device=device),
                classify.make_train_step(cfg, pw.to(device), cls_id, sep_id),
                "examples")
    if mode == "pretrain":
        cfg = PretrainConfig(bert=dataclasses.replace(BertConfig(),
                                                      fused_ln=fused_ln))
        tok = BertTokenizer.from_vocab_file(vocab, remap_unused=False)
        return (CXRPretrainDataset(data, tok, cfg, seed=0), cfg.batch_size,
                cfg.num_workers, pretrain_lib.init_state(cfg, seed=0,
                                                         device=device),
                pretrain_lib.make_train_step(cfg), "pairs")
    args = finetune_main.build_parser().parse_args(
        ["--src_file", data, "--vocab_file", vocab])
    cfg = finetune_main.config_from_args(args)
    cfg = dataclasses.replace(cfg, bert=dataclasses.replace(
        cfg.bert, fused_ln=fused_ln))
    tok = BertTokenizer.from_vocab_file(vocab, remap_unused=True)
    return (Img2TxtDataset(data, tok, cfg, seed=0), cfg.batch_size,
            args.num_workers, finetune_lib.init_state(
                cfg, t_total=1000, seed=0, device=device),
            finetune_lib.make_train_step(cfg), "reports")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["pretrain", "finetune", "classify",
                                       "retrieve"], default="pretrain")
    ap.add_argument("--fused_ln", action="store_true",
                    help="BertConfig.fused_ln on (K3/K4)")
    ap.add_argument("--steps", type=int, default=8,
                    help="micro-steps timed and traced")
    ap.add_argument("--table", type=str, default=None,
                    help="file for the full torch.profiler operator table")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory(prefix="medvill_profile_") as d:
        vocab = os.path.join(d, "vocab.txt")
        chip_smoke.write_vocab(vocab)
        if args.mode == "classify":
            data = chip_smoke.write_clf_data(d, vocab)
        elif args.mode == "retrieve":
            data = chip_smoke.write_retrieval_data(d, vocab)["train"]
        else:
            data = chip_smoke.write_train_data(d, vocab)
        dataset, batch_size, workers, state, step, unit = _setup(
            args.mode, args.fused_ln, data, vocab, device)
        t0 = time.perf_counter()
        if args.mode == "retrieve":
            batches = _pair_batches(dataset, batch_size)
            batch_size *= 2  # rows: a positive and a negative per pair
        else:
            loader = BatchLoader(dataset, batch_size, shuffle=True, seed=0,
                                 workers=workers)
            batches = list(loader)
            loader.close()
        loader_s = time.perf_counter() - t0
    print(json.dumps({"what": "loader", "mode": args.mode,
                      "batches": len(batches), "batch": batch_size,
                      "workers": workers,
                      "ms_per_batch": loader_s / len(batches) * 1e3}),
          flush=True)

    batch = pretrain_lib.to_device(batches[0], device)
    gen = torch.Generator().manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        step(state, batch, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        step(state, batch, gen)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / args.steps * 1e3
    print(json.dumps({"what": "step", "mode": args.mode,
                      "fused_ln": args.fused_ln,
                      "micro_steps": args.steps, "ms_per_micro_step": step_ms,
                      f"{unit}_per_s": batch_size / step_ms * 1e3,
                      "peak_mem_gib": torch.cuda.max_memory_allocated()
                      / 2 ** 30}), flush=True)

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step(state, batch, gen)
        torch.cuda.synchronize()
        traced = time.perf_counter() - t0
    avgs = prof.key_averages()
    cuda = [e for e in avgs
            if str(getattr(e, "device_type", "")).endswith("CUDA")]

    def dev_us(e):
        return _attr(e, "self_device_time_total", "self_cuda_time_total")

    # a record_function range (the optimizer's step) shows on the device
    # timeline as one span from its first kernel to its last: not a kernel
    dev = [e for e in cuda if not e.key.startswith(ANNOTATIONS)]
    optimizer_span_us = sum(dev_us(e) for e in cuda
                            if e.key.startswith("Optimizer.step#"))

    busy_us = sum(dev_us(e) for e in dev)
    by_kind: dict = {}
    for e in dev:
        k = _kind(e.key)
        by_kind[k] = by_kind.get(k, 0.0) + dev_us(e)
    launches = sum(e.count for e in avgs
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                "cudaLaunchKernelExC"))
    top_dev = sorted(dev, key=lambda e: -dev_us(e))[:15]
    print(json.dumps({
        "what": "profile", "mode": args.mode, "fused_ln": args.fused_ln,
        "micro_steps": args.steps, "traced_wall_s": traced,
        "ms_per_micro_step": traced / args.steps * 1e3,
        "device_busy_s": busy_us / 1e6,
        "device_idle_share": 1 - busy_us / 1e6 / traced,
        "kernel_launches_per_micro_step": launches / args.steps,
        "optimizer_step_span_ms_per_micro_step":
            optimizer_span_us / 1e3 / args.steps,
        "device_ms_per_micro_step_by_kind": {
            k: v / 1e3 / args.steps for k, v in
            sorted(by_kind.items(), key=lambda kv: -kv[1])},
        "top_device_ms_per_micro_step": {
            e.key[:70]: dev_us(e) / 1e3 / args.steps for e in top_dev}}),
        flush=True)
    if args.table:
        os.makedirs(os.path.dirname(args.table) or ".", exist_ok=True)
        with open(args.table, "w") as f:
            key = ("self_device_time_total"
                   if hasattr(avgs[0], "self_device_time_total")
                   else "self_cuda_time_total")
            f.write(avgs.table(sort_by=key, row_limit=80))
    return 0


if __name__ == "__main__":
    sys.exit(main())
