"""K4, the fused-LN backward, against an earlier source of it: device times
in one process on one card, in turns (earlier, current, current, earlier).

    python tools/torch_fused_ln_bwd_ab.py --old_source PATH [--rows 15696] \
        [--h 768] [--rounds 2] [--rate0] [--yardsticks] \
        [--variant NAME=SOURCE[@BLOCKS] ...] [--timing_only NAME ...]

PATH is a ``fused_ln.cu`` whose ``medvill_fused_ln_bwd`` has the earlier
interface: one f32 partial row of dgamma and of dbeta per 64-row block,
written to two [ceil(rows / 64), h] arrays and summed by the caller, e.g.
``git show <commit>:medvill_torch/ops/csrc/fused_ln.cu`` of a commit before
the persistent grid.  It is built with nvcc and the package's flags beside
the package's own libraries.  The earlier version's time is its kernel plus
the torch sum over blocks, as its wrapper ran them; the current one's is
``fused_ln.fused_ln_bwd``, one launch.  bf16, rate 0.1, inputs L2-warm;
device times from CUDA graphs (``chip_smoke.device_ms``).  Both are first
held against the plain version (dx, dres one bf16 ulp; dgamma, dbeta 1e-6
per row).  ``--rate0`` also times the current K4 without dropout (the
keep-mask hash's share).  ``--variant NAME=SOURCE`` builds another
``fused_ln.cu`` with the current interface and times its K4 on the
wrapper's grid (or on BLOCKS blocks), in turns with the rest; a variant
named in ``--timing_only`` leaves out part of the work (e.g. the sum over
blocks), so its outputs are not held to the plain version.  ``--yardsticks``
also times PyTorch's own elementwise kernels on tensors of the same shape,
the rate the card streams at: ``torch.add`` (2 reads, 1 write) and an add
with a copy (3 reads, 2 writes: K4's traffic).

One JSON line per timing, then a summary with each side's ptxas report and
the bound.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from medvill_torch.ops import build, fused_ln  # noqa: E402

_OLD_ROWS_PER_BLOCK = 64


def build_source(src: Path, earlier: bool):
    """(the source's medvill_fused_ln_bwd bound with the earlier interface
    or the current one, its ptxas report)."""
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = build.BUILD_DIR / f"libfused_ln_ab-{digest}.so"
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                           str(src)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    fn = ctypes.CDLL(str(out)).medvill_fused_ln_bwd
    p, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
    fn.argtypes = ([p] * 8 + [i] * 4 if earlier else [p] * 9 + [i] * 5) \
        + [u, u, f, f, p]
    fn.restype = i
    return fn, build.ptxas_report(proc.stderr)


def old_bwd(fn, x, res, gamma, dy, *, rate, eps, seed):
    """The earlier wrapper: the kernel, then the torch sum over blocks."""
    h = x.shape[-1]
    rows = x.numel() // h
    n_blocks = -(-rows // _OLD_ROWS_PER_BLOCK)
    dx, dres = torch.empty_like(x), torch.empty_like(res)
    part = torch.empty(2, n_blocks, h, device=x.device, dtype=torch.float32)
    err = fn(x.data_ptr(), res.data_ptr(), gamma.data_ptr(), dy.data_ptr(),
             dx.data_ptr(), dres.data_ptr(), part[0].data_ptr(),
             part[1].data_ptr(), rows, h, int(x.dtype == torch.bfloat16),
             int(rate > 0.0), int(seed) & 0xFFFFFFFF, int(rate * 2 ** 32),
             1.0 / (1.0 - rate), eps,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"earlier K4 launch failed: CUDA error {err}")
    dgamma, dbeta = part.sum(1)
    return dx, dres, dgamma, dbeta


def variant_bwd(fn, n_blocks, x, res, gamma, dy, *, rate, eps, seed):
    """``fn``, a build of another source with the current interface, on
    ``n_blocks`` blocks: the wrapper's launch with another kernel."""
    h = x.shape[-1]
    rows = x.numel() // h
    dx, dres = torch.empty_like(x), torch.empty_like(res)
    dgb = torch.empty(2, h, device=x.device, dtype=torch.float32)
    scratch = torch.empty(2 * n_blocks, 2 * h, device=x.device,
                          dtype=torch.float32)
    stream = torch.cuda.current_stream().cuda_stream
    tickets = fused_ln._ticket_buffer(x.device, stream, n_blocks + 1)
    err = fn(
        x.data_ptr(), res.data_ptr(), gamma.data_ptr(), dy.data_ptr(),
        dx.data_ptr(), dres.data_ptr(), dgb.data_ptr(), scratch.data_ptr(),
        tickets.data_ptr(), rows, h, n_blocks,
        int(x.dtype == torch.bfloat16), int(rate > 0.0),
        int(seed) & 0xFFFFFFFF, int(rate * 2 ** 32), 1.0 / (1.0 - rate), eps,
        stream)
    if err:
        raise RuntimeError(f"K4 launch failed: CUDA error {err}")
    return dx, dres, dgb[0], dgb[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old_source", type=Path, required=True)
    ap.add_argument("--rows", type=int, default=chip_smoke.PRE_B
                    * chip_smoke.PRE_L)
    ap.add_argument("--h", type=int, default=chip_smoke.H)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--rate0", action="store_true")
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--timing_only", action="append", default=[])
    ap.add_argument("--yardsticks", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_fused_ln_bwd_ab: needs a CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    ptxas_new = build.ptxas_report(build.compile_all(["fused_ln"])
                                   ["fused_ln"]["log"])
    old_fn, ptxas_old = build_source(args.old_source, earlier=True)
    variants = {}
    for spec in args.variant:
        name, path = spec.split("=", 1)
        path, _, blocks = path.partition("@")
        variants[name] = (*build_source(Path(path), earlier=False),
                          int(blocks) if blocks else None)
    rows, h = args.rows, args.h
    gen = torch.Generator(device=device).manual_seed(0)
    x, res, dy = (torch.randn(rows, h, device=device, generator=gen)
                  .to(torch.bfloat16) for _ in range(3))
    gamma = torch.randn(h, device=device, generator=gen)
    kw = dict(rate=0.1, eps=1e-12, seed=77)
    per_sm, warps, sms = fused_ln.bwd_residency(device.index, h, True)
    sides = {"earlier": lambda: old_bwd(old_fn, x, res, gamma, dy, **kw),
             "current": lambda: fused_ln.fused_ln_bwd(x, res, gamma, dy,
                                                      **kw)}
    if args.rate0:
        sides["current_rate0"] = lambda: fused_ln.fused_ln_bwd(
            x, res, gamma, dy, **dict(kw, rate=0.0))
    grid = fused_ln.bwd_grid(device.index, h, True, rows)
    for name, (fn, _, blocks) in variants.items():
        sides[name] = (lambda fn=fn, n=blocks or grid: variant_bwd(
            fn, n, x, res, gamma, dy, **kw))
    want = fused_ln.fused_dropout_add_ln_bwd_plain(x, res, gamma, dy, **kw)
    want0 = fused_ln.fused_dropout_add_ln_bwd_plain(x, res, gamma, dy,
                                                    **dict(kw, rate=0.0))
    errs = {}
    for name, fn in sides.items():
        got = fn()
        ref = want0 if name == "current_rate0" else want
        torch.cuda.synchronize()
        errs[name] = {}
        if name in args.timing_only:
            continue
        for i, part in enumerate(("dx", "dres", "dgamma", "dbeta")):
            tol = 1e-6 * rows if i >= 2 else chip_smoke.bf16_tol(ref[i])
            errs[name][part] = chip_smoke.max_err(got[i], ref[i], tol,
                                                  f"{name} {part}")
    if args.yardsticks:
        o1, o2 = torch.empty_like(x), torch.empty_like(x)
        sides["torch_add"] = lambda: torch.add(x, res, out=o1)
        sides["torch_add_copy"] = lambda: (torch.add(x, res, out=o1),
                                           o2.copy_(dy))
    order = ["earlier", "current", "current", "earlier"] + [
        n for n in sides if n not in ("earlier", "current")]
    times = {name: [] for name in sides}
    for rnd in range(args.rounds):
        for name in order:
            ms = chip_smoke.device_ms(lambda fn=sides[name]: fn(), iters=50,
                                      reps=3)
            times[name].append(ms)
            chip_smoke.emit({"round": rnd, "side": name, "ms": ms})
    bound_ms, bound_by = chip_smoke.bound(5 * rows * h * 2 + 3 * h * 4,
                                          20 * rows * h, torch.bfloat16)
    summary = {"device": smi, "rows": rows, "h": h, "dtype": "bfloat16",
               "rate": 0.1, "bound_ms": bound_ms, "bound_by": bound_by,
               "blocks_per_sm": per_sm, "warps_per_block": warps,
               "sms": sms,
               "ms": times,
               "median_ms": {n: statistics.median(t)
                             for n, t in times.items()},
               "share_of_bound": {n: bound_ms / statistics.median(t)
                                  for n, t in times.items()},
               "yardstick_tb_per_s": {
                   n: k * rows * h * 2 / statistics.median(times[n]) / 1e9
                   for n, k in (("torch_add", 3), ("torch_add_copy", 5))
                   if n in times},
               "max_abs_err": errs,
               "ptxas": {side: {n: e for n, e in report.items()
                                if "bwd" in n}
                         for side, report in (("earlier", ptxas_old),
                                              ("current", ptxas_new),
                                              *((v, r) for v, (_, r, _)
                                                in variants.items()))}}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
