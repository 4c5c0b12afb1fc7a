"""Losses of the port's first pretraining steps, fused LN on and off.

    python tools/torch_pretrain_losses.py [--lr 1e-4 1e-5] [--steps 4] \
        [--draws fresh|repeated]

The configuration of chip_smoke.py's ``train-fused`` phase: PretrainConfig
defaults (BERT-base, ResNet-50 random-pixel encoder at 512 px, L = 436,
BAR, dropout 0.1, bf16 compute) at batch 36 with accumulation 1, so every
micro-step is an AdamW update, on the first batch of chip_smoke.py's
synthetic records, repeated.  For each ``--lr`` and for ``fused_ln`` off
and on, a model from seed 0 takes ``--steps`` steps.  ``--draws fresh``
draws each step's pixel indices and dropout seed from one generator, as
the CLI does; ``repeated`` gives every step the same draws, so the loss
moves only with the parameters.  One JSON line per (lr, fused_ln) with the
losses of each step.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from medvill_torch.config import (BertConfig, ImageEncoderConfig,  # noqa: E402
                                  PretrainConfig)
from medvill_torch.train import pretrain as pretrain_lib  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lr", type=float, nargs="+", default=[1e-4, 1e-5])
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--draws", choices=("fresh", "repeated"),
                    default="fresh")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    base = PretrainConfig(bert=BertConfig(), image=ImageEncoderConfig(),
                          batch_size=chip_smoke.PRE_B,
                          gradient_accumulation_steps=1)
    with tempfile.TemporaryDirectory(prefix="medvill_losses_") as d:
        vocab = os.path.join(d, "vocab.txt")
        chip_smoke.write_vocab(vocab)
        data = chip_smoke.write_train_data(d, vocab)
        batch = chip_smoke._train_batch(data, vocab, base, device,
                                        base.batch_size)
    for lr in args.lr:
        for fused in (False, True):
            cfg = dataclasses.replace(
                base, lr=lr,
                bert=dataclasses.replace(base.bert, fused_ln=fused))
            state = pretrain_lib.init_state(cfg, seed=0, device=device)
            step = pretrain_lib.make_train_step(cfg)
            gen = torch.Generator().manual_seed(0)
            rows = []
            for _ in range(args.steps):
                if args.draws == "repeated":
                    gen = torch.Generator().manual_seed(0)
                m = step(state, batch, gen)
                rows.append({k: m[k].item()
                             for k in ("loss", "mlm_loss", "itm_loss")})
            print(json.dumps({"lr": lr, "fused_ln": fused,
                              "draws": args.draws,
                              "loss": [r["loss"] for r in rows],
                              "mlm_loss": [r["mlm_loss"] for r in rows],
                              "itm_loss": [r["itm_loss"] for r in rows]}),
                  flush=True)
            del state
    return 0


if __name__ == "__main__":
    sys.exit(main())
