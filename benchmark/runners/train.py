"""The training runner: one run of a training cell.

Its traffic file adds ``steps_per_dispatch``, ``pool_batches`` and
``check_dispatches`` (the micro-steps per dispatch, the batches the window
cycles through, and the dispatches at the start whose results the
comparison checks); its entry (``entries/<entry>.py``) builds the
program's configuration, training state and micro-step.

A run:

1. builds the program's configuration with its CLI's parser and checks it
   against the configuration file's numbers; starts CUDA; loads the
   kernels; draws the pool of batches (``traffic.make_pool``); builds the
   program's training state and loads the benchmark's weights into it;
2. resets the device's peak memory and drives the state through the
   window's own ``MultiStep`` and ``dispatch_loader`` for
   ``check_dispatches`` dispatches: every micro-step's loss, the
   optimizer's first moment after the first dispatch and each parameter's
   change after the last are kept for the comparison.  These dispatches
   also capture the CUDA graphs, so nothing compiles in the window;
3. measures: dispatches for ``--seconds``, at most ``IN_FLIGHT`` of them
   queued on the device, then a device sync.  The rate is the micro-steps
   finished times the batch, over the window's wall time.  With ``--trace
   1`` the window runs under ``torch.profiler`` with the benchmark's spans,
   and the per-layer metrics are read;
4. reads the peak memory, closes the feed, checks that no JAX module is
   loaded, frees the program's state, makes the weights again and runs the
   reference (``reference.follow``) over the checked micro-steps, and
   compares (``compare``).

``setup_s`` runs from the process's start to the first timed micro-step;
``pieces`` splits it.
"""
from __future__ import annotations

import dataclasses
import gc
import itertools
import math
import statistics
import time
from typing import Dict, List

from benchmark import harness

# dispatches the window's loop lets the device hold before it waits for the
# oldest: the CLIs' loops read a loss back every --log_freq dispatches, and
# a loop that never waits would queue the whole window's batches on the
# device
IN_FLIGHT = 2
# the numbers ``compare`` gives, each with its limit in limits/<cell>.json
NUMBERS = ("loss_gap", "moment_gap", "moment_shape_gap", "change_gap")
# what the runner takes from an entry
ENTRY = ("MODEL", "FAMILY", "MOMENT", "program_config", "init_state",
         "make_step", "mask_name", "optimizer", "sequence")


@dataclasses.dataclass
class ProgramReadings:
    losses: List[float]
    moment_norms: Dict[str, float]
    change_norms: Dict[str, float]


def leaf_gaps(p: Dict[str, float], r: Dict[str, float],
              names) -> Dict[str, float]:
    """Per parameter: |program's norm - reference's| over the larger of
    the reference's norm and its median over ``names``."""
    names = list(names)
    if not names:
        return {}
    med = statistics.median(r[n] for n in names)
    out = {}
    for n in names:
        gap = abs(p.get(n, math.nan) - r[n]) / max(r[n], med, 1e-30)
        out[n] = gap if math.isfinite(gap) else math.inf
    return out


def kept(ref, exclude: float = 1e-3) -> List[str]:
    """The parameters whose change is compared: the first reference
    gradient at least ``exclude`` of the median one."""
    g = ref.grad_norms
    med = statistics.median(g.values())
    return [n for n in ref.change_norms if g[n] >= exclude * med]


def shape_gap(p: Dict[str, float], r: Dict[str, float], names) -> float:
    """The median parameter's departure from the common scale: the median
    over ``names`` of |log(p / r) - the median log(p / r)|."""
    logs = []
    for n in names:
        if not (p.get(n, math.nan) > 0 and r[n] > 0):
            return math.inf
        logs.append(math.log(p[n] / r[n]))
    if not logs:
        return math.inf
    mid = statistics.median(logs)
    return statistics.median(abs(x - mid) for x in logs)


def compare(prog, ref, exclude: float = 1e-3) -> Dict[str, float]:
    """The numbers that decide ``correct``:

    - ``loss_gap``: the largest |program - reference| / |reference| over
      the checked micro-steps' losses;
    - ``moment_gap``: over the trained parameters, the largest gap between
      the program's and the reference's norm of the optimizer's first
      moment after the first dispatch, over the larger of the reference's
      norm and its median over the parameters (pretraining: one update, so
      the first mean gradient times 1 - beta1);
    - ``moment_shape_gap``: how far the median parameter's first-moment
      norm departs from the scale that all of them share (``shape_gap``,
      over the parameters that ``change_gap`` reads).  The program's
      norms move together by up to ±0.6% from seed to seed, which makes a
      worst or a median parameter's gap swing; their spread about that
      common scale is steady, and it is the number that tells the bf16
      program from its float8 control;
    - ``change_gap``: the largest gap of each parameter's change over the
      checked dispatches, leaving out the parameters whose first reference
      gradient is under ``exclude`` of the median one (a key's bias under
      softmax: moved by round-off alone).
    A missing, non-positive or non-finite reading gives infinity."""
    if len(prog.losses) != len(ref.losses):
        loss_gap = math.inf
    else:
        loss_gap = max((abs(a - b) / abs(b) if math.isfinite(a) else math.inf)
                       for a, b in zip(prog.losses, ref.losses))
    names = kept(ref, exclude)
    moments = leaf_gaps(prog.moment_norms, ref.moment_norms,
                        ref.moment_norms)
    changes = leaf_gaps(prog.change_norms, ref.change_norms, names)
    return {"loss_gap": loss_gap,
            "moment_gap": max(moments.values(), default=math.inf),
            "moment_shape_gap": shape_gap(prog.moment_norms,
                                          ref.moment_norms, names),
            "change_gap": max(changes.values(), default=math.inf)}


def diagnosis(prog, ref, n: int = 3) -> List[str]:
    """The parameters that read the largest gaps, and the losses."""
    out = []
    for what, p, r, names in (
            ("moment", prog.moment_norms, ref.moment_norms,
             ref.moment_norms),
            ("change", prog.change_norms, ref.change_norms, kept(ref))):
        gaps = leaf_gaps(p, r, names)
        top = sorted(gaps.items(), key=lambda kv: -kv[1])[:n]
        out.append(f"worst {what}: " + ", ".join(
            f"{name} {gap:.4g} ({p.get(name, math.nan):.4g} vs "
            f"{r[name]:.4g})" for name, gap in top))
    out.append("losses (program, reference): " + ", ".join(
        f"{a:.6f}/{b:.6f}" for a, b in zip(prog.losses, ref.losses)))
    return out


def reference(cell: harness.Cell, entry, pool: list, seed: int, device,
              **kw):
    """The plain reference over the cell's checked micro-steps, from the
    run's weights, batches and draws; ``kw`` goes to ``follow``."""
    from benchmark import weights
    from benchmark.reference.follow import follow

    dims, mix = cell.dims, cell.traffic
    k = mix["steps_per_dispatch"]
    w = weights.make(entry.MODEL, dims, harness.sub_seed(seed, "weights"),
                     device)
    opt = dict(entry.optimizer(dims, mix), **kw.pop("optimizer", {}))
    return follow(entry.MODEL, dims, opt, w,
                  [pool[i % len(pool)]
                   for i in range(mix["check_dispatches"] * k)],
                  harness.sub_seed(seed, "draws"),
                  dims["gradient_accumulation_steps"], k, device=device,
                  **kw)


def _named_trainable(model) -> Dict[str, object]:
    return {n: p for n, p in model.named_parameters() if p.requires_grad}


def _moment_norms(state, key: str) -> Dict[str, float]:
    opt = state.tx.optimizer
    return {n: float(opt.state[p][key].norm()) if key in opt.state[p]
            else 0.0 for n, p in _named_trainable(state.model).items()}


def _window_work(entry, dims: dict, pool: list, indices: List[int]):
    """(least seconds of K1..K4 over the window's calls, model FLOPs) of
    the micro-steps that ran pool batches ``indices``."""
    from benchmark import flops

    L, img_block = entry.sequence(dims)
    heads = dims["num_attention_heads"]
    head_dim = dims["hidden_size"] // heads
    layers = dims["num_hidden_layers"]
    per_batch = []
    for batch in pool:
        vis = flops.visible(entry.FAMILY, batch["mask_spec"], L, img_block)
        k1, k2 = flops.attention_bounds(vis, heads, head_dim)
        k3, k4 = flops.ln_bounds(vis.shape[0] * L, dims["hidden_size"])
        per_batch.append(({"K1": k1 * layers, "K2": k2 * layers,
                           "K3": k3 * 2 * layers, "K4": k4 * 2 * layers},
                          flops.model_flops(batch, dims, entry.FAMILY,
                                            img_block, vis)))
    bounds = {k: sum(per_batch[i][0][k] for i in indices)
              for k in ("K1", "K2", "K3", "K4")}
    if not dims.get("fused_ln"):
        bounds["K3"] = bounds["K4"] = 0.0
    return bounds, sum(per_batch[i][1] for i in indices)


@dataclasses.dataclass
class Window:
    seconds: float
    dispatches: int
    losses: "torch.Tensor"      # every micro-step's, on the host
    prof: object = None         # the profiler that traced it


def _window(multi, state, feed, generator, seconds: float, traced: bool,
            dev) -> Window:
    """Dispatches for ``seconds``, at most ``IN_FLIGHT`` queued on the
    device, then a device sync; with ``traced`` under the profiler and the
    benchmark's spans."""
    import torch

    cuda = dev.type == "cuda"
    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else []))
        prof.start()
    losses, done, n = [], [], 0
    with harness.span(traced, "window"):
        t0 = time.perf_counter()
        while True:
            if len(done) >= IN_FLIGHT:
                with harness.span(traced, "device_wait"):
                    done.pop(0).synchronize()
            with harness.span(traced, "loader_wait"):
                batch, _ = next(feed)
            with harness.span(traced, "dispatch"):
                out = multi(state, batch, generator)
            if cuda:
                done.append(torch.cuda.Event())
                done[-1].record()
            losses.append(out["loss"])
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        if cuda:
            torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
    if prof is not None:
        prof.stop()
    return Window(t1 - t0, n, torch.cat([x.float().reshape(-1)
                                         for x in losses]).cpu(), prof)


def _per_layer(cell: harness.Cell, entry, prof, pool: list,
               indices: List[int]):
    """(the reduced trace, the cell's per-layer metrics) of a traced
    window whose micro-steps ran pool batches ``indices``."""
    from benchmark import flops
    from benchmark import trace as trace_lib

    tr = trace_lib.reduce(prof)
    bounds, model_flops = _window_work(entry, cell.dims, pool, indices)
    micro = len(indices)
    ctx = harness.TraceContext(
        tr, micro_steps=micro,
        updates=micro // cell.dims["gradient_accumulation_steps"],
        bounds=bounds, flops=model_flops, peak_flops=flops.BF16_FLOPS_PER_S)
    return tr, harness.read_metrics(cell, ctx)


def run(cell: harness.Cell, seed: int, seconds: float, traced: bool,
        t_start: float, device: str = "cuda", fault=None):
    """Returns (the result's line as a dict, the lines for standard
    error).  ``fault``, for the tests only, is called with the program's
    state and step before the first dispatch and may break them."""
    import torch

    from medvill_torch.data.pretrain import dispatch_loader
    from medvill_torch.train.dispatch import MultiStep

    from benchmark import traffic, weights

    pieces: Dict[str, float] = {}
    mark = [t_start]

    def piece(name: str) -> None:
        now = time.perf_counter()
        pieces[name] = now - mark[0]
        mark[0] = now

    dims, mix = cell.dims, cell.traffic
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    entry = harness.load_entry(cell)
    piece("import")
    cfg = harness.program_config(entry, dims)
    if cuda:
        torch.zeros((), device=dev)
    piece("cuda")
    if cuda:
        from medvill_torch.ops import build

        for lib in ("flash_attention", "fused_ln"):
            build.library(lib)
    piece("kernels")
    B, k = dims["batch_size"], mix["steps_per_dispatch"]
    pool = traffic.make_pool(cell, harness.sub_seed(seed, "traffic"))
    piece("pool")
    state = entry.init_state(cfg, dims, mix, dev)
    piece("state")
    w = weights.make(entry.MODEL, dims, harness.sub_seed(seed, "weights"),
                     dev)
    weights.load_into(state.model, w)
    trained = _named_trainable(state.model)
    del w
    step = entry.make_step(cfg)
    if fault is not None:
        step = fault(state, step) or step
    multi = MultiStep(step, k)
    generator = torch.Generator().manual_seed(harness.sub_seed(seed,
                                                               "draws"))
    feed = iter(dispatch_loader(itertools.cycle(pool), dev, k=k))
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    piece("weights")
    checked: List[float] = []
    moments: Dict[str, float] = {}
    for d in range(mix["check_dispatches"]):
        batch, is_group = next(feed)
        if not is_group:
            raise RuntimeError("the feed gave a lone batch")
        checked += multi(state, batch, generator)["loss"].float().tolist()
        if d == 0:
            moments = _moment_norms(state, entry.MOMENT)
    # the starting weights made again: the same seed on the same device
    w = weights.make(entry.MODEL, dims, harness.sub_seed(seed, "weights"),
                     dev)
    with torch.no_grad():
        change = {n: float((p - w[n]).norm()) for n, p in trained.items()}
    del w
    dispatched = mix["check_dispatches"]
    if cuda:
        torch.cuda.synchronize(dev)
    piece("checked")
    setup_s = time.perf_counter() - t_start

    window = _window(multi, state, feed, generator, seconds, traced, dev)
    dispatched += window.dispatches
    micro = window.dispatches * k
    rate = micro * B / window.seconds
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    feed.close()
    failed = int((~torch.isfinite(window.losses)).sum())
    found = harness.jax_modules()
    if found:
        raise SystemExit(f"JAX modules loaded in the benchmark's process: "
                         f"{found}")
    del multi, state, trained, feed, batch, step
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    result = {"correct": False, "attempted": micro, "failed": failed}
    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda else
                   "cpu", "count": cell.chips if cuda else 1,
                   "memory_peak_bytes": int(peak)}
    lines = [f"card: {harness.power_limit() if cuda else 'cpu'}",
             "setup pieces (s): " + ", ".join(f"{n} {v:.3f}"
                                              for n, v in pieces.items())]
    if traced:
        first = (dispatched - window.dispatches) * k
        tr, metrics = _per_layer(cell, entry, window.prof, pool, [
            (first + i) % len(pool) for i in range(micro)])
        device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result.update(metrics=metrics, device=device_info,
                      breakdown=tr.breakdown())
        lines.append(f"traced window {tr.window_s:.3f} s, {micro} "
                     f"micro-steps, {micro * B / tr.window_s:.3f} "
                     f"samples/s")
    else:
        values = {"train_samples_per_s": rate, "peak_mem_gib": peak /
                  harness.GIB, "setup_s": setup_s}
        result.update(metrics={n: {"value": values[n], "unit": m["unit"]}
                               for n, m in cell.end_to_end.items()
                               if n in values},
                      device=device_info)
    lines.append(f"window {window.seconds:.3f} s, {micro} micro-steps, "
                 f"{rate:.3f} samples/s; setup {setup_s:.3f} s")

    t_ref = time.perf_counter()
    ref = reference(cell, entry, pool, seed, dev)
    readings = ProgramReadings(checked, moments, change)
    numbers = compare(readings, ref)
    lines += diagnosis(readings, ref)
    limits = {n: cell.limits[n]["limit"] for n in numbers}
    result["correct"] = all(numbers[n] <= limits[n] for n in numbers)
    lines.append(f"reference {time.perf_counter() - t_ref:.3f} s")
    result["pieces"] = pieces
    result["check"] = {n: {"value": numbers[n], "limit": limits[n]}
                       for n in numbers}
    lines += [f"{n} {numbers[n]!r} limit {limits[n]!r}" for n in numbers]
    return result, lines
