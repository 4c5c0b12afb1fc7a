"""Why the overfit chain's pretrain ITM target is met in some runs and not
in others, on one NVIDIA GPU (tools/torch_overfit.py's pretrain workload:
the structured 16-record corpus, a 2-layer 128-wide BERT at 64 px, batch
8, 400 epochs).

    python tools/torch_overfit_itm.py [--seeds 123 1 2 3 4 7] [--epochs 400]

One JSON line per result:

- kernels: K1/K2 at the workload's call (B 8, L 14, 2 heads x 64, BAR,
  img_block 5, rate 0.1) with a device seed from ``DropoutRNG``, against
  their plain versions (max abs error of o, lse, dq, dk, dv; f32);
- step: one pretrain step of the workload's model in f32 on the card,
  the attention kernels against their plain versions (the same seeds):
  the loss and each gradient's largest error over its scale, the worst
  six;
- runs: the pretrain workload at each seed with the attention kernels
  (the CLI as it runs) and with ``use_flash_attention`` off
  (``mha_reference``: dense bias, Bernoulli dropout from the generator),
  the best 10-epoch MLM and ITM accuracies, the first epoch whose mean
  ITM loss is below 0.5 (the ITM "cracks"), seconds.

It first prints the card's name and power limit.  Needs a CUDA device.
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

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_overfit as ov  # noqa: E402
from medvill_torch.cli import make_tokenizer, pretrain_main  # noqa: E402
from medvill_torch.data.pretrain import (BatchLoader,  # noqa: E402
                                         CXRPretrainDataset)
from medvill_torch.ops import flash_attention as fa  # noqa: E402
from medvill_torch.ops.dropout import DropoutRNG  # noqa: E402
from medvill_torch.train import pretrain as tpre  # noqa: E402

B, L, HEADS, IMG_BLOCK = 8, 3 + 2 + 9, 2, 3 + 2


def kernels(device) -> dict:
    """K1/K2 against their plain versions with a device seed, three
    consecutive seeds of one DropoutRNG."""
    rng = DropoutRNG(123, device)
    gen = torch.Generator(device=device).manual_seed(1)
    q, k, v, do = (torch.randn(B, L, HEADS, fa.HEAD_DIM, device=device,
                               generator=gen) for _ in range(4))
    spec = torch.tensor([[2, t] for t in (1, 3, 5, 7, 9, 8, 6, 4)],
                        dtype=torch.int32, device=device)
    worst = {}
    for _ in range(3):
        kw = dict(img_block=IMG_BLOCK, l_real=L, family=fa.FAMILY_PRETRAIN,
                  rate=0.1, seed=rng.next_seed())
        o, lse = fa.attn_fwd(q, k, v, spec, **kw)
        got = dict(zip(("dq", "dk", "dv"),
                       fa.attn_bwd(q, k, v, o, do, lse, spec, **kw)))
        want_o, want_lse = fa.attn_fwd_plain(q, k, v, spec, **kw)
        want = dict(zip(("dq", "dk", "dv"), fa.attn_bwd_plain(
            q, k, v, o, do, lse, spec, **kw)))
        for name, a, b in (("o", o, want_o), ("lse", lse, want_lse),
                           *((n, got[n], want[n]) for n in got)):
            worst[name] = max(worst.get(name, 0.0),
                              (a - b).abs().max().item())
    return {"what": "kernels", "max_abs_err": worst}


def _plain_attention(spec, rate: float):
    def fn(q, k, v, bias, rng=None, deterministic=True):
        r = 0.0 if deterministic else rate
        return fa.attn_fwd_plain(q, k, v, spec, img_block=IMG_BLOCK,
                                 l_real=q.shape[1], family=fa.FAMILY_PRETRAIN,
                                 rate=r, seed=rng.next_seed() if r else 0)[0]
    return fn


def step(root: str, device) -> dict:
    """One f32 pretrain step of the workload's model, kernel path against
    plain path from the same weights, batch and seeds."""
    data = os.path.join(root, "pretrain", "Train.jsonl")
    argv = ["--train_dataset", data, "--vocab_file",
            os.path.join(root, "vocab.txt"), "--bert_model", ov.SMALL_BERT,
            "--vocab_size", "32", "--batch_size", str(B),
            "--num_image_embeds", "3", "--img_size", "64", "--seq_len", "8"]
    cfg = pretrain_main.config_from_args(
        pretrain_main.build_parser().parse_args(argv))
    cfg = dataclasses.replace(cfg, bert=dataclasses.replace(
        cfg.bert, compute_dtype="float32"))
    ds = CXRPretrainDataset(data, make_tokenizer(argv[3]), cfg, seed=0)
    batch = tpre.to_device(next(iter(BatchLoader(ds, B, shuffle=False))),
                           device)
    model = tpre.init_state(cfg, seed=0, device=device).model
    buffers = {n: b.clone() for n, b in model.named_buffers()}
    pix = torch.tensor([0, 1, 3], device=device)
    out = {}
    for path in ("kernel", "plain"):
        model.zero_grad(set_to_none=True)
        with torch.no_grad():
            for n, b in model.named_buffers():
                b.copy_(buffers[n])
        attention = (None if path == "kernel" else _plain_attention(
            batch["mask_spec"], cfg.bert.attention_probs_dropout_prob))
        loss, _ = tpre.pretrain_loss_and_metrics(
            model, batch, DropoutRNG(5, device), pix, cfg, train=True,
            attention_fn=attention)
        loss.backward()
        out[path] = (loss.item(), {n: p.grad.clone() for n, p in
                                   model.named_parameters()
                                   if p.grad is not None})
    rel = sorted((((out["kernel"][1][n] - g).abs().max()
                   / g.abs().max().clamp(min=1e-12)).item(), n)
                 for n, g in out["plain"][1].items())[::-1]
    return {"what": "step", "loss": [out["kernel"][0], out["plain"][0]],
            "worst_grad_err_over_scale": rel[:6]}


def runs(root: str, seeds, epochs: int, device: str = "cuda") -> None:
    real = pretrain_main.config_from_args
    try:
        for seed in seeds:
            for kernels_on in (True, False):
                def config(args, kernels_on=kernels_on):
                    return dataclasses.replace(
                        real(args), use_flash_attention=kernels_on)
                pretrain_main.config_from_args = config
                out = os.path.join(root, f"run-{seed}-{kernels_on}")
                t0 = time.time()
                res = ov.run_pretrain(root, out, epochs, device, seed)
                rows = ov._rows(os.path.join(out, "metrics.jsonl"))
                crack = next((r["epoch"] for r in rows
                              if r["avg_itm_loss"] < 0.5), None)
                print(json.dumps({
                    "what": "run", "seed": seed,
                    "attention": "kernels" if kernels_on else "mha_reference",
                    **res["detail"], "target_met": res["ok"],
                    "first_epoch_itm_loss_below_0.5": crack,
                    "seconds": time.time() - t0}), flush=True)
    finally:
        pretrain_main.config_from_args = real


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", type=int, nargs="+",
                   default=[123, 1, 2, 3, 4, 7])
    p.add_argument("--epochs", type=int, default=400)
    a = p.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    device = torch.device("cuda")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    with tempfile.TemporaryDirectory(prefix="medvill_itm_") as d:
        root = os.path.join(d, "data")
        ov.make_structured_tree(root, 16)
        # the f32 comparisons without TF32; the runs as the CLI runs
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(json.dumps(kernels(device)), flush=True)
        print(json.dumps(step(root, device)), flush=True)
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
        runs(root, a.seeds, a.epochs)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
