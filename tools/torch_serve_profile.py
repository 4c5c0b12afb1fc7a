"""Where the time goes in the port's greedy decode on one NVIDIA GPU.

    python tools/torch_serve_profile.py [--batch 8] [--steps 128] \
        [--table out/torch_serve_profile.txt]

Builds the serving model of chip_smoke.py (BERT-base VLP + ResNet-50 at
512 px, random weights from seed 0, bf16 compute, fused LN on), decodes one
batch to warm up, then:

- times one full greedy decode by the host clock (ending in a sync);
- traces one decode with torch.profiler and prints the device busy time,
  the idle share (1 - busy / traced wall), the kernel launch count, and the
  top operators by device and by host time;
- times the fused-LN wrapper per call on the host (checks + launch) against
  the bare ctypes launch, at the decode window shape.

One JSON line per result; ``--table`` also writes the full operator table
to that file.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from medvill_torch.config import BertConfig, ImageEncoderConfig  # noqa: E402
from medvill_torch.models import decoder  # noqa: E402
from medvill_torch.models.seq2seq import (VLPForPreTraining,  # noqa: E402
                                          init_weights)
from medvill_torch.ops import fused_ln  # noqa: E402


def _attr(evt, *names):
    for n in names:
        if hasattr(evt, n):
            return getattr(evt, n)
    return 0.0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=128)
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
    bert = dataclasses.replace(BertConfig.vlp(BertConfig.base()),
                               fused_ln=True)
    model = VLPForPreTraining(bert, ImageEncoderConfig(
        num_image_embeds=256, img_size=512, encoder="full-fiber"),
        len_vis_input=256)
    init_weights(model, 0)
    model = model.prepare_for_compute().eval().to(device)
    image = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (args.batch, 512, 512, 3), dtype=np.uint8)).to(device)
    settings = decoder.DecodeSettings(max_txt_length=args.steps,
                                      mask_word_id=103, eos_id=102)

    def run():
        with torch.inference_mode():
            ids, _, _ = decoder.greedy_decode(model, image, settings, 101, 102)
        return ids.cpu()

    run()
    t0 = time.perf_counter()
    run()
    wall = time.perf_counter() - t0
    print(json.dumps({"what": "greedy_decode", "batch": args.batch,
                      "steps": args.steps, "wall_s": wall,
                      "ms_per_step": wall / (args.steps + 1) * 1e3,
                      "tokens_per_s": args.batch * args.steps / wall}),
          flush=True)

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        traced = time.perf_counter() - t0
    avgs = prof.key_averages()
    dev = [e for e in avgs
           if str(getattr(e, "device_type", "")).endswith("CUDA")]
    busy_us = sum(_attr(e, "self_device_time_total", "self_cuda_time_total")
                  for e in dev)
    launches = sum(e.count for e in avgs
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                "cudaLaunchKernelExC"))
    top_dev = sorted(dev, key=lambda e: -_attr(
        e, "self_device_time_total", "self_cuda_time_total"))[:10]
    top_cpu = sorted(avgs, key=lambda e: -e.self_cpu_time_total)[:10]
    print(json.dumps({
        "what": "profile", "traced_wall_s": traced,
        "device_busy_s": busy_us / 1e6,
        "device_idle_share": 1 - busy_us / 1e6 / traced,
        "kernel_launches": launches,
        "launches_per_step": launches / (args.steps + 1),
        "top_device_us": {e.key[:60]: _attr(e, "self_device_time_total",
                                            "self_cuda_time_total")
                          for e in top_dev},
        "top_host_self_us": {e.key[:60]: e.self_cpu_time_total
                             for e in top_cpu}}), flush=True)
    if args.table:
        os.makedirs(os.path.dirname(args.table) or ".", exist_ok=True)
        with open(args.table, "w") as f:
            f.write(avgs.table(sort_by="self_cpu_time_total", row_limit=60))

    # the fused-LN wrapper's host cost at the window shape
    x = torch.randn(args.batch * 2, 768, device=device, dtype=torch.bfloat16)
    res = torch.randn_like(x)
    g, b = torch.ones(768, device=device), torch.zeros(768, device=device)
    n = 2000
    fused_ln.fused_dropout_add_ln(x, res, g, b, rate=0.0, eps=1e-5, seed=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fused_ln.fused_dropout_add_ln(x, res, g, b, rate=0.0, eps=1e-5,
                                      seed=0)
    torch.cuda.synchronize()
    wrapper_us = (time.perf_counter() - t0) / n * 1e6
    y = torch.empty_like(x)
    kern = fused_ln._kernel()
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = (x.data_ptr(), res.data_ptr(), g.data_ptr(), b.data_ptr(),
            y.data_ptr())
    t0 = time.perf_counter()
    for _ in range(n):
        kern(*ptrs, x.shape[0], 768, 1, 0, 0, 0, 1.0, 1e-5, stream)
    torch.cuda.synchronize()
    bare_us = (time.perf_counter() - t0) / n * 1e6
    print(json.dumps({"what": "fused_ln_host_cost", "rows": x.shape[0],
                      "wrapper_us_per_call": wrapper_us,
                      "bare_ctypes_us_per_call": bare_us}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
