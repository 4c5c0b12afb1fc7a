"""The pretraining step as the pretrain CLI builds it.

The configuration comes from ``medvill_torch.cli.pretrain_main``'s parser
and ``config_from_args`` over the configuration file's ``argv``, then its
``overrides``; the state from ``medvill_torch.train.pretrain.init_state``
(CXRBERT, AdamW over the trainable parameters, accumulated); the
micro-step from ``make_train_step``.  The optimizer's first moment is
AdamW's ``exp_avg``.
"""
from __future__ import annotations

MODEL = "cxrbert"
FAMILY = "pretrain"
MOMENT = "exp_avg"


def program_config(argv):
    from medvill_torch.cli import pretrain_main

    return pretrain_main.config_from_args(
        pretrain_main.build_parser().parse_args(argv))


def init_state(cfg, dims: dict, traffic: dict, device):
    from medvill_torch.train import pretrain

    return pretrain.init_state(cfg, seed=0, device=device)


def make_step(cfg):
    from medvill_torch.train import pretrain

    return pretrain.make_train_step(cfg)


def mask_name(cfg) -> str:
    return cfg.resolve_variant().name


def optimizer(dims: dict, traffic: dict) -> dict:
    return {"name": "adamw", "lr": dims["lr"], "beta1": dims["beta1"],
            "beta2": dims["beta2"], "eps": dims["eps"],
            "weight_decay": dims["weight_decay"]}


def sequence(dims: dict) -> tuple:
    """(L, image block) of the joint sequence."""
    n = dims["num_image_embeds"]
    return dims["seq_len"] + n + 3, n + 2
