"""The report-generation finetune step as the finetune CLI builds it.

The configuration comes from ``medvill_torch.cli.finetune_main``'s parser
and ``config_from_args`` over the configuration file's ``argv``, then its
``overrides``; the state from ``medvill_torch.train.finetune.init_state``
(the VLP model, BertAdam over ``t_total`` updates, accumulated), where
``t_total`` is what the CLI computes for a run of ``epochs`` over the
pool (``pool_batches * epochs // accumulation``); the micro-step from
``make_train_step`` with drop-worst off (its ratio is 0 until the epoch
after ``--drop_after``).  The optimizer's first moment is BertAdam's
``m``.
"""
from __future__ import annotations

MODEL = "vlp"
FAMILY = "seq2seq"
MOMENT = "m"


def program_config(argv):
    from medvill_torch.cli import finetune_main

    return finetune_main.config_from_args(
        finetune_main.build_parser().parse_args(argv))


def t_total(dims: dict, traffic: dict) -> int:
    return max(1, traffic["pool_batches"] * dims["epochs"]
               // dims["gradient_accumulation_steps"])


def init_state(cfg, dims: dict, traffic: dict, device):
    from medvill_torch.train import finetune

    return finetune.init_state(cfg, t_total(dims, traffic), seed=0,
                               device=device)


def make_step(cfg):
    from medvill_torch.train import finetune

    return finetune.make_train_step(cfg, 0.0)


def mask_name(cfg) -> str:
    if cfg.bar:
        return "bar"
    return "s2s" if cfg.s2s_prob >= 1.0 and cfg.bi_prob == 0 else "mixed"


def optimizer(dims: dict, traffic: dict) -> dict:
    return {"name": "bertadam", "lr": dims["lr"],
            "t_total": t_total(dims, traffic), "warmup": dims["warmup"],
            "weight_decay": dims["weight_decay"]}


def sequence(dims: dict) -> tuple:
    return dims["max_seq_length"], dims["num_image_embeds"] + 2
