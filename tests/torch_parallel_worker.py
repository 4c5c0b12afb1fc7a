"""One rank of the port's scale-out scenarios on the CPU (gloo), for
tests/test_torch_port_parallel_ranks.py (``steps``) and
tests/test_torch_port_parallel_clis.py (``clis``), which start two of
these with a launcher's variables (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) and read what they
write:

    python tests/torch_parallel_worker.py INPUTS OUT_DIR steps|clis

``INPUTS`` is a ``torch.save`` of the configurations, weights and global
batches (made by the test from the JAX package's data pipeline; a rank
waits for it to appear); each rank writes ``OUT_DIR/rank<r>.pt``.  Rank 0
also runs the single-process reference of most steps (the layout set
aside: no collective), which the test holds the two-rank run against.
Imports no JAX, one torch thread per process.
"""
from __future__ import annotations

import contextlib
import json
import os
import signal
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from medvill_torch import checkpoint as ckpt  # noqa: E402
from medvill_torch import parallel  # noqa: E402
from medvill_torch.cli import classification_main, pretrain_main  # noqa: E402
from medvill_torch.data.pretrain import BatchLoader  # noqa: E402
from medvill_torch.models.cxrbert import CXRBERT  # noqa: E402
from medvill_torch.train import classify as tclf  # noqa: E402
from medvill_torch.train import finetune as tft  # noqa: E402
from medvill_torch.train import optim  # noqa: E402
from medvill_torch.train import pretrain as tpre  # noqa: E402
from medvill_torch.utils import preempt  # noqa: E402
from medvill_torch.utils.logging import watch_norms  # noqa: E402


TIGHT_CLIP = 1e-6  # BertAdam's max_grad_norm in the tensor-parallel runs


@contextlib.contextmanager
def single_process():
    """The layout set aside: a step here runs no collective."""
    saved = parallel._LAYOUT
    parallel._LAYOUT = None
    try:
        yield
    finally:
        parallel._LAYOUT = saved


def tensors(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def rows(batch):
    return tensors(parallel.local_rows(dict(batch)))


def full_params(model):
    return {n: parallel.full_param(p, p.detach()).clone()
            for n, p in model.named_parameters()}


def full_grads(model):
    return {n: parallel.full_param(p, p.grad).clone()
            for n, p in model.named_parameters() if p.grad is not None}


def pretrain_grads(inp):
    """One training forward/backward of the MLM+ITM loss on this rank's
    rows of the global batch, the gradients summed."""
    cfg, batch = inp["cfg"], inp["batch"]
    model = CXRBERT(cfg.bert, cfg.image, img_position=cfg.img_position)
    model.load_state_dict(inp["sd"])
    parallel.place(tpre.TrainState(model, optim.Accumulate(optim.adamw(
        optim.trainable(model), 1e-3), 1)))
    local = rows(batch)
    loss, m = tpre.pretrain_loss_and_metrics(
        model, local, None, torch.from_numpy(inp["pix"]).long(), cfg,
        train=True)
    loss.backward()
    parallel.all_reduce_grads([p.grad for p in model.parameters()
                               if p.grad is not None])
    out = {"local_mlm_total": int(m["mlm_total"]),
           "metrics": {k: v.detach().clone()
                       for k, v in parallel.sum_metrics(m).items()},
           "grads": full_grads(model),
           "stats": {k: v.clone() for k, v in model.state_dict().items()
                     if k.endswith(("running_mean", "running_var"))}}
    return out


def pretrain_steps(inp, zero1=False):
    """Three AdamW micro-steps from the same weights over the global
    batches (this rank's rows)."""
    cfg = inp["cfg"]
    ts = tpre.init_state(cfg, seed=0, device="cpu")
    ts.model.load_state_dict(inp["sd"])
    parallel.place(ts, zero1)
    step = tpre.make_train_step(cfg)
    gen = torch.Generator().manual_seed(0)
    metrics = [step(ts, rows(b), gen) for b in inp["batches"]]
    out = {"params": full_params(ts.model),
           "loss": [float(m["loss"]) for m in metrics],
           "tx": ts.tx.state_dict(),
           "buffers": {k: v.clone() for k, v in ts.model.state_dict().items()
                       if k.endswith(("running_mean", "running_var"))}}
    if zero1:
        out["moment_elements"] = sum(
            v.numel() for st in ts.tx.optimizer.state.values()
            for k, v in st.items() if k in ("exp_avg", "exp_avg_sq"))
        out["full_moment_elements"] = 2 * sum(
            p.numel() for p in ts.tx.zero1.params)
    return out


def first_grads(ts, step, batch):
    """The gradients (summed over the data group) and metrics of one
    forward/backward of ``step``'s loss on ``batch``, no update."""
    loss, m = step.loss_fn(ts.model, rows(batch), None, None)
    loss.backward()
    params = [p for p in ts.model.parameters() if p.grad is not None]
    parallel.all_reduce_grads([p.grad for p in params])
    out = {"grads": full_grads(ts.model),
           "metrics": {k: v.detach().clone()
                       for k, v in parallel.sum_metrics(m).items()}}
    for p in params:
        p.grad = None
    return out


def clipped(ts, clip):
    """BertAdam's per-tensor clip at ``clip`` where given: small enough that
    it binds on every tensor, which the tensor-parallel runs need to show
    it reads the whole tensor's norm."""
    if clip is not None:
        ts.tx.optimizer.max_grad_norm = clip


TRUNK = "img_encoder.model."  # the ResNet trunk's parameter names


def without_trunk(ts, out):
    """``out``'s parameters and optimizer state less the ResNet trunk's (the
    bulk of the bytes; replicated under tensor parallelism)."""
    names = {id(p): n for n, p in ts.model.named_parameters()}
    out["params"] = {k: v for k, v in out["params"].items() if TRUNK not in k}
    out["tx"]["state"] = [{} if TRUNK in names[id(p)] else row for p, row in
                          zip(ts.tx.params(), out["tx"]["state"])]
    return out


def finetune_steps(inp, zero1=False, clip=None):
    """Two BertAdam steps of the report-generation finetune (drop-worst at
    ``inp["ratio"]``, the trunk trained); without ZeRO-1 or ``clip`` also
    the first step's gradients; at ``clip`` nothing of the trunk."""
    cfg = inp["cfg"]
    ts = tft.init_state(cfg, t_total=4, seed=0, device="cpu")
    clipped(ts, clip)
    parallel.place(ts, zero1)
    step = tft.make_train_step(cfg, inp["ratio"])
    out = ({} if zero1 or clip is not None
           else first_grads(ts, step, inp["batches"][0]))
    gen = torch.Generator().manual_seed(0)
    metrics = [step(ts, rows(b), gen) for b in inp["batches"]]
    out.update(params=full_params(ts.model),
               loss=[float(m["loss"]) for m in metrics],
               tx=ts.tx.state_dict())
    return out if clip is None else without_trunk(ts, out)


def classify_steps(inp, zero1=False, clip=None):
    """The classification step's gradients (the trunk trained under
    train-mode BatchNorm), then two BertAdam steps; at ``clip`` the
    optimizer's state instead of the gradients, and nothing of the
    trunk."""
    cfg, n = inp["cfg"], inp["n_labels"]
    ts = tclf.init_state(cfg, n, t_total=4, seed=0, device="cpu")
    clipped(ts, clip)
    parallel.place(ts, zero1)
    step = tclf.make_train_step(cfg, torch.ones(n), inp["cls"], inp["sep"])
    out = ({} if zero1 or clip is not None
           else first_grads(ts, step, inp["batches"][0]))
    gen = torch.Generator().manual_seed(0)
    metrics = [step(ts, rows(b), gen) for b in inp["batches"]]
    out.update(params=full_params(ts.model),
               loss=[float(m["loss"]) for m in metrics],
               buffers={k: v.clone() for k, v in ts.model.state_dict().items()
                        if k.endswith(("running_mean", "running_var"))})
    if clip is None:
        return out
    out["tx"] = ts.tx.state_dict()
    return without_trunk(ts, out)


def batch_norm(seed=0):
    """One train-mode BatchNorm layer in float64 (this rank's rows of an
    [6, 5, 3, 3] input): output, input gradient (gathered in rank order),
    weight and bias gradients (summed over the data group) and the moved
    running statistics."""
    from medvill_torch.models import resnet

    g = torch.Generator().manual_seed(seed)
    x = torch.randn(6, 5, 3, 3, generator=g, dtype=torch.float64) * 3 + 1
    r = torch.randn(6, 5, 3, 3, generator=g, dtype=torch.float64)
    bn = torch.nn.BatchNorm2d(5).double()
    with torch.no_grad():
        bn.weight.copy_(torch.rand(5, generator=g, dtype=torch.float64) + .5)
        bn.bias.copy_(torch.randn(5, generator=g, dtype=torch.float64))
    xl = parallel.local_rows({"x": x})["x"].clone().requires_grad_(True)
    rl = parallel.local_rows({"r": r})["r"]
    y = resnet._bn(bn, xl, torch.float64, train=True)
    (y * rl).sum().backward()
    parallel.all_reduce_grads([bn.weight.grad, bn.bias.grad])
    gather = (parallel.gather_rows if parallel.data_parallel()
              else lambda t: t.detach())
    return {"y": gather(y), "dx": gather(xl.grad), "dw": bn.weight.grad,
            "db": bn.bias.grad, "mean": bn.running_mean,
            "var": bn.running_var}


def both(fn, *args, **kw):
    """(the two-rank run, rank 0's single-process run or None)."""
    got = fn(*args, **kw)
    ref = None
    if parallel.is_main():
        with single_process():
            ref = fn(*args, **kw)
    parallel.barrier()
    return got, ref


class FlagOnRankOne:
    """A ``PreemptionGuard`` stand-in raised on rank 1 alone, from its
    ``at``-th read on."""

    at = 1

    def __init__(self, logger=None):
        self.polls = 0
        self.signum = signal.SIGTERM

    @property
    def triggered(self):
        self.polls += 1
        return int(os.environ["RANK"]) == 1 and self.polls >= self.at

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def pretrain_argv(data, out, *extra):
    return ["--train_dataset", data["train"], "--vocab_file", data["vocab"],
            "--output_path", out, "--bert_model", "test-tiny",
            "--vocab_size", "64", "--img_size", "64", "--num_image_embeds",
            "3", "--seq_len", "12", "--batch_size", "2", "--epochs", "2",
            "--gradient_accumulation_steps", "2", "--num_workers", "1",
            "--lr", "1e-3", "--device", "cpu", "--log_freq", "1", *extra]


def counted_dispatches(run):
    """``run()`` with the pretrain CLI's dispatches counted on this rank."""
    real, n = pretrain_main.dispatch_loader, [0]

    def counting(*a, **kw):
        for item in real(*a, **kw):
            n[0] += 1
            yield item

    pretrain_main.dispatch_loader = counting
    try:
        run()
    finally:
        pretrain_main.dispatch_loader = real
    return n[0]


def preemption(data, out):
    """The pretrain CLI on two ranks with ZeRO-1: uninterrupted; then
    stopped by a flag on rank 1 alone and relaunched."""
    straight = os.path.join(out, "straight")
    stopped = os.path.join(out, "stopped")
    argv = ("--zero1", "true")
    pretrain_main.main(pretrain_argv(data, straight, *argv))
    real = preempt.PreemptionGuard
    preempt.PreemptionGuard = FlagOnRankOne
    try:
        n = counted_dispatches(lambda: pretrain_main.main(
            pretrain_argv(data, stopped, *argv)))
    finally:
        preempt.PreemptionGuard = real
    marker = preempt.read_marker(stopped)
    parallel.barrier()
    pretrain_main.main(pretrain_argv(data, stopped, *argv))
    return {"dispatches_before_stop": n, "marker": marker,
            "straight": straight, "stopped": stopped}


def tp_checkpoint(data, out):
    """The pretrain CLI at --model_parallel 2 --zero1 true with the eval
    and a watch row per dispatch; rank 0 then loads its files into one
    process, evaluates the test records again and takes the norms."""
    run = os.path.join(out, "tp_run")
    pretrain_main.main(pretrain_argv(
        data, run, "--model_parallel", "2", "--zero1", "true", "--epochs",
        "1", "--test_dataset", data["test"], "--watch_interval", "1"))
    res = {"run": run}
    if parallel.is_main():
        with single_process():
            args = pretrain_main.build_parser().parse_args(pretrain_argv(
                data, run, "--epochs", "1"))
            cfg = pretrain_main.config_from_args(args)
            ts = tpre.init_state(cfg, device="cpu")
            ckpt.restore_training_state(run, 0, ts)
            tok = pretrain_main.make_tokenizer(data["vocab"])
            ds = pretrain_main.CXRPretrainDataset(data["test"], tok, cfg,
                                                  seed=cfg.seed + 1)
            agg = {}
            ds.rng.seed(cfg.seed + 1)
            step = tpre.make_eval_step(cfg)
            for b in BatchLoader(ds, cfg.batch_size, shuffle=False):
                for k, v in step(ts.model, tensors(b)).items():
                    agg.setdefault(k, []).append(float(v))
            res["reloaded_eval_loss"] = float(np.mean(agg["loss"]))
            with open(os.path.join(run, "metrics.jsonl")) as f:
                res["run_eval_loss"] = json.loads(
                    f.readline())["eval_avg_loss"]
            res["reloaded_watch"] = watch_norms(ts.model, ts.tx)
            with open(os.path.join(run, pretrain_main.WATCH_FILE)) as f:
                res["run_watch"] = json.loads(f.readlines()[-1])
    parallel.barrier()
    return res


def classification_cli(data, out):
    """The classification CLI on two ranks, one epoch with the test."""
    save = os.path.join(out, "clf")
    res = classification_main.main([
        "--data_path", data["dir"], "--vocab_file", data["vocab"],
        "--bert_model", "test-tiny", "--vocab_size", "64", "--img_size",
        "64", "--num_image_embeds", "4", "--max_seq_len", "20", "--batch_sz",
        "3", "--max_epochs", "1", "--do_test", "true", "--Test_dset_name",
        "Valid.jsonl", "--savedir", save, "--device", "cpu",
        "--model_parallel", "2"])
    return {"test": res["test"], "savedir": save}


def timed(res, name, fn, *args, **kw):
    t0 = time.perf_counter()
    res[name] = fn(*args, **kw)
    res.setdefault("seconds", {})[name] = time.perf_counter() - t0


def steps(inp, out_dir, res) -> None:
    """The steps of each workload, two ranks against one process."""
    parallel.configure(1)  # data parallelism over both ranks
    timed(res, "dp_batch_norm", both, batch_norm)
    timed(res, "dp_grads", pretrain_grads, inp["pre"])
    timed(res, "dp_steps", both, pretrain_steps, inp["pre3"])
    timed(res, "dp_finetune", both, finetune_steps, inp["ft"])
    timed(res, "dp_classify", both, classify_steps, inp["clf"])
    res["dp_finetune_lr"] = inp["ft"]["cfg"].lr
    res["dp_classify_lr"] = inp["clf"]["cfg"].lr
    timed(res, "zero1_steps", pretrain_steps, inp["pre3"], zero1=True)
    timed(res, "zero1_finetune", finetune_steps, inp["ft"], zero1=True)
    parallel.configure(2)  # both ranks hold one model
    timed(res, "tp_grads", both, pretrain_grads, inp["pre"])
    timed(res, "tp_steps", both, pretrain_steps, inp["pre3"])
    timed(res, "tp_zero1_steps", pretrain_steps, inp["pre3"], zero1=True)
    for case, fn, key in (("finetune", finetune_steps, "ft"),
                          ("classify", classify_steps, "clf")):
        timed(res, f"tp_{case}", both, fn, inp[key], clip=TIGHT_CLIP)
        timed(res, f"tp_zero1_{case}", fn, inp[key], zero1=True,
              clip=TIGHT_CLIP)
    parallel.reset()


def clis(inp, out_dir, res) -> None:
    """The training CLIs under the launcher's variables."""
    timed(res, "preemption", preemption, inp["data"], out_dir)
    timed(res, "tp_checkpoint", tp_checkpoint, inp["data"], out_dir)
    timed(res, "classification_cli", classification_cli, inp["data"],
          out_dir)


def main(inputs: str, out_dir: str, part: str) -> None:
    torch.set_num_threads(1)
    parallel.initialize(torch.device("cpu"))
    deadline = time.time() + 600  # the test may start the ranks first
    while not os.path.exists(inputs):
        if time.time() > deadline:
            raise TimeoutError(f"no {inputs}")
        time.sleep(0.1)
    res = {}
    {"steps": steps, "clis": clis}[part](
        torch.load(inputs, weights_only=False), out_dir, res)
    torch.save(res, os.path.join(out_dir, f"rank{os.environ['RANK']}.pt"))
    parallel.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:4])
