"""Pretraining CLI of the port (the counterpart of
medvill_tpu/cli/pretrain_main.py, with its flag names and defaults for
data, tasks, mask variants, schedule, model and optimizer).

    python -m medvill_torch.cli.pretrain_main --train_dataset train.jsonl \
        --vocab_file vocab.txt [--BAR_attn true] [--device cuda]

It runs ``--epochs`` over the dataset: ``BatchLoader``, prefetched and
placed on the device on a background thread (``dispatch_loader``) -> the
train step of
``medvill_torch.train.pretrain``, or with ``--steps_per_dispatch k`` > 1
its k-micro-step dispatch over groups of k batches (CUDA graphs on the
card, a loop of eager steps on the CPU; an epoch's tail batches train
alone) (AdamW at constant ``--lr``: the JAX CLI
parses ``--warmup`` and applies no schedule, and neither does this one;
``--dropout_prob`` is parsed and, as there, does not change the model's
dropout rates).  At the end of every ``--save_interval``-th epoch and of the
last one it writes ``<output_path>/model.<epoch>.bin``, a state dict in the
reference pretrain layout (``enc.* mlm.predictions.* itm.linear.*``;
``medvill_torch.convert.load_cxrbert_checkpoint`` reads it), and appends
the epoch's metrics to ``<output_path>/metrics.jsonl``.

It runs on the card unless ``--device cpu`` is given, and raises on a host
without one.  Not ported (ROADMAP.md): resume and preemption,
``--test_dataset`` eval, the mesh/parallelism
flags, ``--watch_interval``, ``--profile_dir``, ``--hf_bert_checkpoint`` and
``--resnet_init_path``; argparse rejects them like any unknown flag.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List

import torch

from medvill_torch.cli import collect_metrics, str2bool
from medvill_torch.config import (BertConfig, ImageEncoderConfig,
                                  PretrainConfig)
from medvill_torch.convert import load_cxrbert_checkpoint
from medvill_torch.data.pretrain import (BatchLoader, CXRPretrainDataset,
                                         dispatch_loader)
from medvill_torch.data.tokenization import BertTokenizer
from medvill_torch.train.dispatch import MultiStep
from medvill_torch.train.pretrain import init_state, make_train_step
from medvill_torch.utils.device import resolve_device
from medvill_torch.utils.logging import create_logger
from medvill_torch.utils.seed import set_seed


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    # datasets (reference: main_origin.py:68-73)
    p.add_argument("--train_dataset", type=str, required=True)
    p.add_argument("--vocab_file", type=str, required=True,
                   help="BERT wordpiece vocab.txt")
    p.add_argument("--output_path", type=str, default="output")
    p.add_argument("--log_freq", type=int, default=10)
    # tasks
    p.add_argument("--mlm_task", type=str2bool, default=True)
    p.add_argument("--itm_task", type=str2bool, default=True)
    # mask variants (main_origin.py:90-95)
    p.add_argument("--attn_1d", type=str2bool, default=False)
    p.add_argument("--BAR_attn", type=str2bool, default=True)
    p.add_argument("--Mixed", type=str2bool, default=False)
    p.add_argument("--s2s_prob", type=float, default=1.0)
    p.add_argument("--bi_prob", type=float, default=0.0)
    p.add_argument("--disturbing_mask", type=str2bool, default=False)
    # schedule (main_origin.py:97-99)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--batch_size", type=int, default=36)
    p.add_argument("--num_workers", type=int, default=4,
                   help="loader worker threads; >1 derives a per-(seed, "
                        "epoch, index) RNG per sample, 1 draws from one "
                        "sequential stream")
    # model (main_origin.py:102-139)
    p.add_argument("--hidden_size", type=int, default=768)
    p.add_argument("--embedding_size", type=int, default=768)
    p.add_argument("--bert_model", type=str, default="bert-base-scratch",
                   choices=["bert-base-scratch", "bert-small-scratch",
                            "bert-base-uncased",
                            "google/bert_uncased_L-4_H-512_A-8",
                            "google/bert_uncased_L-2_H-128_A-2",
                            "test-tiny"])
    p.add_argument("--vocab_size", type=int, default=30522)
    p.add_argument("--weight_load", type=str2bool, default=False)
    p.add_argument("--pre_trained_model_path", type=str, default=None,
                   help="with --weight_load: a pretrain checkpoint file in "
                        "the CXRBERT layout to start from")
    p.add_argument("--img_postion", type=str2bool, default=True)
    p.add_argument("--seq_len", type=int, default=253)
    p.add_argument("--max_seq_len", type=int, default=512)
    p.add_argument("--img_hidden_sz", type=int, default=2048)
    p.add_argument("--img_encoder", type=str, default="random-pixel",
                   choices=["random-pixel", "full-fiber"])
    p.add_argument("--img_channel", type=int, default=3)
    p.add_argument("--num_image_embeds", type=int, default=180)
    p.add_argument("--img_size", type=int, default=512)
    # optimizer (main_origin.py:141-151)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--gradient_accumulation_steps", type=int, default=4)
    p.add_argument("--warmup", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--dropout_prob", type=float, default=0.1)
    p.add_argument("--beta1", type=float, default=0.9)
    p.add_argument("--beta2", type=float, default=0.999)
    p.add_argument("--eps", type=float, default=1e-6)
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--save_interval", type=int, default=1,
                   help="checkpoint every N epochs (the last one always)")
    p.add_argument("--freeze_img_trunk", type=str2bool, default=True,
                   help="freeze the entire ResNet trunk (the reference's "
                        "executed behavior, cxrbert_origin.py:65-70); false "
                        "trains it")
    p.add_argument("--steps_per_dispatch", type=int, default=1,
                   help="train micro-steps per dispatch, replayed as CUDA "
                        "graphs (amortizes per-dispatch overhead; the JAX "
                        "CLI's lax.scan).  Epoch-tail batches that do not "
                        "fill a group still train, individually, via a "
                        "single-step dispatch.")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def config_from_args(args) -> PretrainConfig:
    bert = BertConfig.from_name(args.bert_model, vocab_size=args.vocab_size)
    image = ImageEncoderConfig(
        encoder=args.img_encoder, img_size=args.img_size,
        img_channel=args.img_channel, img_hidden_size=args.img_hidden_sz,
        num_image_embeds=args.num_image_embeds,
        freeze_prefix_stages=args.freeze_img_trunk)
    return PretrainConfig(
        train_dataset=args.train_dataset, output_path=args.output_path,
        log_freq=args.log_freq, mlm_task=args.mlm_task,
        itm_task=args.itm_task, attn_1d=args.attn_1d,
        bar_attn=args.BAR_attn, mixed=args.Mixed, s2s_prob=args.s2s_prob,
        bi_prob=args.bi_prob, disturbing_mask=args.disturbing_mask,
        epochs=args.epochs, batch_size=args.batch_size,
        num_workers=args.num_workers, bert=bert, image=image, lr=args.lr,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        warmup=args.warmup, seed=args.seed, dropout_prob=args.dropout_prob,
        beta1=args.beta1, beta2=args.beta2, eps=args.eps,
        weight_decay=args.weight_decay, weight_load=args.weight_load,
        pre_trained_model_path=args.pre_trained_model_path,
        img_position=args.img_postion, seq_len=args.seq_len,
        max_seq_len=args.max_seq_len)


def _epoch_row(agg: Dict[str, List[torch.Tensor]]) -> dict:
    sums = {k: torch.stack(v).float().sum().item() for k, v in agg.items()}
    n = len(agg["loss"])
    row = {f"avg_{k}": torch.stack(v).float().mean().item()
           for k, v in agg.items()}
    if "mlm_correct" in sums:
        row["mlm_acc"] = sums["mlm_correct"] / max(sums["mlm_total"], 1)
    if "itm_correct" in sums:
        row["itm_acc"] = sums["itm_correct"] / max(sums["itm_total"], 1)
    row["micro_steps"] = n
    return row


def train(args) -> List[dict]:
    """Runs the epochs; returns one metrics row per epoch."""
    device = resolve_device(args.device)
    set_seed(args.seed)
    cfg = config_from_args(args)
    os.makedirs(cfg.output_path, exist_ok=True)
    logger = create_logger(os.path.join(cfg.output_path, "train.log"), args)

    tokenizer = BertTokenizer.from_vocab_file(args.vocab_file,
                                              remap_unused=False)
    dataset = CXRPretrainDataset(cfg.train_dataset, tokenizer, cfg,
                                 seed=cfg.seed)
    loader = BatchLoader(dataset, cfg.batch_size, shuffle=True,
                         seed=cfg.seed, workers=cfg.num_workers)
    if len(loader) == 0:
        raise ValueError(f"{cfg.train_dataset}: {len(dataset)} records make "
                         f"no batch of {cfg.batch_size}")
    state = init_state(cfg, device=device)
    restored = bool(cfg.weight_load and cfg.pre_trained_model_path)
    if restored:
        load_cxrbert_checkpoint(state.model, cfg.pre_trained_model_path)
        logger.info("restored %s", cfg.pre_trained_model_path)
    if cfg.image.freeze_prefix_stages and not restored:
        # the checkpoint, when restored, holds the trunk too
        logger.warning("the ResNet trunk is frozen (reference semantics) "
                       "and randomly initialized: no ImageNet weights are "
                       "loaded by the port")
    k = max(1, args.steps_per_dispatch)
    train_step = make_train_step(cfg)
    multi_step = MultiStep(train_step, k)
    generator = torch.Generator().manual_seed(cfg.seed)
    rows = []
    try:
        for epoch in range(cfg.epochs):
            t0 = time.perf_counter()
            agg: Dict[str, List[torch.Tensor]] = {}
            for i, (batch, is_group) in enumerate(
                    dispatch_loader(loader, device, k=k)):
                m = (multi_step if is_group else train_step)(
                    state, batch, generator)
                collect_metrics(agg, m, is_group)
                if i % cfg.log_freq == 0:
                    logger.info("epoch %d it %d loss %.4f", epoch, i,
                                m["loss"].float().mean().item())
            row = _epoch_row(agg)  # reads the device: the epoch has ended
            row.update(epoch=epoch, epoch_time_s=time.perf_counter() - t0)
            row["pairs_per_s"] = (row["micro_steps"] * cfg.batch_size
                                  / row["epoch_time_s"])
            rows.append(row)
            logger.info("epoch %d done: %s", epoch, row)
            with open(os.path.join(cfg.output_path, "metrics.jsonl"),
                      "a") as f:
                f.write(json.dumps(row) + "\n")
            if (epoch + 1) % max(1, args.save_interval) == 0 \
                    or epoch + 1 == cfg.epochs:
                path = os.path.join(cfg.output_path, f"model.{epoch}.bin")
                torch.save({k: v.detach().cpu() for k, v in
                            state.model.state_dict().items()}, path)
                logger.info("saved %s", path)
    finally:
        loader.close()
    return rows


def main(argv=None) -> List[dict]:
    return train(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
