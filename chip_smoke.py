"""Smoke run of the medvill_torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as one JSON line; any failure exits non-zero:

1. build: every kernel under medvill_torch/ops/csrc/ with nvcc (one process
   per source, all at once), with ptxas' register/spill report.
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

Then the line of kernels, and last {"ok": true, "device": {...}}.  Without
a CUDA device it prints the reason to stderr and exits 1.
"""
from __future__ import annotations

import base64
import io
import json
import logging
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

from medvill_torch.cli import serve_main
from medvill_torch.convert import load_vlp_checkpoint
from medvill_torch.models import decoder
from medvill_torch.models.seq2seq import VLPForPreTraining, init_weights
from medvill_torch.ops import build, fused_ln

HBM_BYTES_PER_S = 3.35e12      # H100 SXM (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12        # H100 SXM f32 outside the tensor cores
H = 768
BATCH, T_MAX, VIS, IMG = 8, 128, 256, 512
N_REQUESTS = 12
SEED = 0


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


def device_ms(fn, iters: int = 100, reps: int = 5) -> float:
    """Device time of one ``fn()``: ``iters`` calls captured in one CUDA
    graph and replayed, so the host's launch cost is out of the figure."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
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


def phase_build() -> None:
    t0 = time.perf_counter()
    report = build.compile_all()
    ptxas = {name: [ln.strip() for ln in r["log"].splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, r in report.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": {n: r["seconds"] for n, r in report.items()},
          "ptxas": ptxas})


def phase_kernel(device) -> dict:
    """Kernel vs plain at the serve shapes; returns the kernels-line entry
    (prefill shape, bf16)."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    eps = 1e-5
    entry = None
    for shape_name, rows in (("prefill", BATCH * (VIS + 2)),
                             ("window", BATCH * 2)):
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
            if shape_name == "prefill" and dtype == torch.bfloat16:
                entry = rec
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
    return entry


def _write_fixture(d: str) -> list:
    """Vocab, config.json and a random full-width checkpoint; returns the
    serve CLI arguments."""
    vocab = os.path.join(d, "vocab.txt")
    with open(vocab, "w") as f:
        for tok in ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]:
            f.write(tok + "\n")
        for i in range(30522 - 5):
            f.write(f"tok{i}\n")
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
        fused_ln.fused_dropout_add_ln.launches = 0
        t0 = time.perf_counter()
        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(N_REQUESTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t0
        launches = fused_ln.fused_dropout_add_ln.launches
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
    import dataclasses

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
    phase_build()
    entry = phase_kernel(device)
    with tempfile.TemporaryDirectory(prefix="medvill_smoke_") as d:
        argv = _write_fixture(d)
        launches = phase_serve(argv)
        phase_parity(argv, device)
    emit({"kernels": [{
        "name": "fused_dropout_add_ln", "route": "cuda",
        "source": "medvill_torch/ops/csrc/fused_ln.cu",
        "replaces": "medvill_tpu/ops/fused_ln.py:57",
        "launches": launches, "max_abs_err": entry["max_abs_err"],
        "ms": entry["kernel_ms"], "plain_ms": entry["plain_ms"],
        "bound_ms": entry["bound_ms"], "bound_by": entry["bound_by"],
        "library_ms": entry["library_ms"]}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
