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
dropout rates).  ``--hf_bert_checkpoint`` (alias ``--bert_init_path``) and
``--resnet_init_path`` initialize the encoder and the trunk from torch
files (``torch_init``), then ``--weight_load`` restores
``--pre_trained_model_path``: a CXRBERT-layout file, or a run directory
whose latest saved epoch restores the whole training state; a warning
names a frozen trunk that none of them set.

At the end of every ``--save_interval``-th epoch and of the last one it
writes ``<output_path>/model.<epoch>.bin``, a state dict in the reference
pretrain layout (``enc.* mlm.predictions.* itm.linear.*``;
``medvill_torch.convert.load_cxrbert_checkpoint`` reads it), and
``optim.<epoch>.bin``, the rest of the training state
(``checkpoint.save_training_state``), and appends the epoch's metrics,
with ``--test_dataset``'s held-out eval (``eval_avg_*``, K1 alone on the
card), to ``<output_path>/metrics.jsonl``.  Every ``--watch_interval``
dispatches it appends parameter and Adam-moment norms to ``watch.jsonl``;
``--profile_dir`` gets a torch.profiler Chrome trace of dispatches 2-4 of
epoch 0 (``pretrain_trace.json``).

Preemption (``utils/preempt.py``): SIGTERM is read after every dispatch.
Mid-epoch it ends the step, stops the prefetch, saves the whole state
under the epoch and writes ``preempt.json`` with the host batches trained;
in the eval or the save it saves and marks the whole epoch.  The process
then returns (exit 0).  A relaunch of the same command restores from the
marker (before ``--pre_trained_model_path``), skips the trained batches
(``BatchLoader.skip_next``) and continues bit for bit as the run that was
not stopped.

``--img_encoder ViT`` replaces the ResNet trunk by the patch embedding
(``models/joint.py``, patch 32; ``--num_image_embeds`` must be the patch
count, 256 at 512 px): nothing is frozen and no pixels are drawn, and
``--resnet_init_path`` raises, as in the JAX CLI.

It runs on the card unless ``--device cpu`` is given, and raises on a host
without one.  Not ported (ROADMAP.md): the mesh/parallelism flags (and
with them ``global_any``, the hosts' agreement to stop) and an orbax
directory as ``--pre_trained_model_path``
(``medvill_tpu.cli.export_main`` converts one); argparse rejects them like
any unknown flag.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List

import torch

from medvill_torch import checkpoint as ckpt
from medvill_torch import torch_init
from medvill_torch.cli import collect_metrics, make_tokenizer, str2bool
from medvill_torch.config import (BertConfig, ImageEncoderConfig,
                                  PretrainConfig)
from medvill_torch.convert import load_cxrbert_checkpoint
from medvill_torch.data.pretrain import (BatchLoader, CXRPretrainDataset,
                                         dispatch_loader)
from medvill_torch.train.dispatch import MultiStep
from medvill_torch.train.pretrain import (init_state, make_eval_step,
                                          make_train_step, to_device)
from medvill_torch.utils import preempt
from medvill_torch.utils.device import resolve_device
from medvill_torch.utils.logging import create_logger, watch_norms
from medvill_torch.utils.seed import set_seed

TRACE_FILE = "pretrain_trace.json"
WATCH_FILE = "watch.jsonl"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    # datasets (reference: main_origin.py:68-73)
    p.add_argument("--train_dataset", type=str, required=True)
    p.add_argument("--test_dataset", type=str, default=None,
                   help="held-out records: the MLM/ITM eval after each "
                        "epoch (eval_avg_* in metrics.jsonl)")
    p.add_argument("--vocab_file", type=str, required=True,
                   help="BERT wordpiece vocab.txt")
    p.add_argument("--output_path", type=str, default="output")
    p.add_argument("--log_freq", type=int, default=10)
    p.add_argument("--watch_interval", type=int, default=1000,
                   help="dispatches between parameter and Adam-moment norm "
                        "rows in watch.jsonl (the reference's wandb.watch, "
                        "models/train_origin.py:51); 0 disables")
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
                        "the CXRBERT layout, or a run directory whose "
                        "latest saved epoch restores the whole training "
                        "state")
    p.add_argument("--img_postion", type=str2bool, default=True)
    p.add_argument("--seq_len", type=int, default=253)
    p.add_argument("--max_seq_len", type=int, default=512)
    p.add_argument("--img_hidden_sz", type=int, default=2048)
    p.add_argument("--img_encoder", type=str, default="random-pixel",
                   choices=["random-pixel", "full-fiber", "ViT"])
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
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler Chrome trace of dispatches "
                        "2-4 of epoch 0 here")
    p.add_argument("--save_interval", type=int, default=1,
                   help="checkpoint every N epochs (the last one always; "
                        "preemption saves are unaffected)")
    p.add_argument("--hf_bert_checkpoint", "--bert_init_path",
                   dest="hf_bert_checkpoint", type=str, default=None,
                   help="torch state_dict of an HF BERT to initialize the "
                        "joint encoder (cxrbert_origin.py:42-55)")
    p.add_argument("--resnet_init_path", type=str, default=None,
                   help="torchvision resnet50 .pth to initialize the "
                        "visual trunk (models/image.py:50 pretrained=True)")
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
        train_dataset=args.train_dataset, test_dataset=args.test_dataset,
        output_path=args.output_path,
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


def _initialize(args, cfg: PretrainConfig, state, generator,
                logger) -> None:
    """The JAX CLI's initializers, in its order (:207-268): an HF BERT file
    into the joint encoder, a torchvision ResNet-50 into the trunk, then
    ``--weight_load`` from ``--pre_trained_model_path``: a file in the
    CXRBERT layout, or a run directory whose latest saved epoch restores
    the whole training state (model, optimizer, micro-steps and the host
    ``generator``).  A path that is neither raises."""
    if args.hf_bert_checkpoint:
        torch_init.init_bert_from_torch(
            state.model, args.hf_bert_checkpoint, enc_key="enc",
            num_layers=cfg.bert.num_hidden_layers)
        logger.info("initialized joint encoder from %s",
                    args.hf_bert_checkpoint)
    if args.resnet_init_path:
        torch_init.init_resnet_from_torch(state.model, args.resnet_init_path,
                                          trunk_path=("enc", "img_encoder"))
        logger.info("initialized visual trunk from %s (trunk frozen=%s)",
                    args.resnet_init_path, cfg.image.freeze_prefix_stages)
    path = cfg.pre_trained_model_path
    restored = bool(cfg.weight_load and path)
    if restored and os.path.isfile(path):
        load_cxrbert_checkpoint(state.model, path)
        logger.info("restored %s", path)
    elif restored:
        epoch = ckpt.latest_epoch(path)
        if epoch is None:
            raise FileNotFoundError(
                f"--pre_trained_model_path {path}: neither a checkpoint file "
                "nor a run directory with model.<N>.bin and optim.<N>.bin")
        ckpt.restore_training_state(path, epoch, state, generator)
        logger.info("restored %s epoch %d", path, epoch)
    if cfg.image.freeze_prefix_stages and cfg.image.encoder != "ViT" \
            and not args.resnet_init_path and not restored:
        # the reference freezes an ImageNet trunk (image.py:50); the
        # checkpoint, when restored, holds the trunk too; a ViT model has
        # no trunk
        logger.warning(
            "the ResNet trunk is frozen (reference semantics) and randomly "
            "initialized: pass --resnet_init_path with torchvision "
            "ResNet-50 weights for reference-equivalent training, or "
            "--freeze_img_trunk false to train the trunk")


def _resume(cfg: PretrainConfig, state, generator, loader,
            logger) -> tuple:
    """(first epoch, host batches of it to skip): a preempted run's marker
    in ``--output_path`` restores its whole state (it takes precedence
    over ``--pre_trained_model_path``, which that run already holds); a
    marker that covers its epoch continues at the next one (:303-361)."""
    marker = preempt.read_marker(cfg.output_path)
    if marker is None:
        return 0, 0
    start, skip = int(marker["epoch"]), int(marker["batches_done"])
    ckpt.restore_training_state(cfg.output_path, start, state, generator,
                                loader)
    preempt.clear_marker(cfg.output_path)
    logger.info("resuming preempted run from %s: epoch %d, %d host batches "
                "already trained", cfg.output_path, start, skip)
    return loader.resume_at(start, skip)


def _start_trace(device: torch.device):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _stop_trace(prof, device: torch.device, directory: str, logger) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, TRACE_FILE)
    prof.export_chrome_trace(path)
    logger.info("wrote the profile of dispatches 2-4 to %s", path)


def _evaluate(eval_step, state, test_loader, test_ds, seed: int,
              device) -> dict:
    """The held-out eval's ``eval_avg_<k>`` over ``test_loader``; the test
    set's stream restarts from its seed, so every eval (and a resumed
    run's) sees the same masked inputs."""
    test_ds.rng.seed(seed)
    t0 = time.perf_counter()
    agg: Dict[str, List[torch.Tensor]] = {}
    for batch in test_loader:
        collect_metrics(agg, eval_step(state.model, to_device(batch, device)),
                        False)
    row = {f"eval_avg_{k}": torch.stack(v).float().mean().item()
           for k, v in agg.items()}
    row["eval_time_s"] = time.perf_counter() - t0
    row["eval_batches"] = len(agg.get("loss", ()))
    return row


def train(args) -> List[dict]:
    """Runs the epochs; returns one metrics row per epoch trained (none
    after a preemption in this process's first epoch)."""
    device = resolve_device(args.device)
    set_seed(args.seed)
    cfg = config_from_args(args)
    os.makedirs(cfg.output_path, exist_ok=True)
    logger = create_logger(os.path.join(cfg.output_path, "train.log"), args)

    tokenizer = make_tokenizer(args.vocab_file, remap_unused=False)
    dataset = CXRPretrainDataset(cfg.train_dataset, tokenizer, cfg,
                                 seed=cfg.seed)
    loader = BatchLoader(dataset, cfg.batch_size, shuffle=True,
                         seed=cfg.seed, workers=cfg.num_workers)
    if len(loader) == 0:
        raise ValueError(f"{cfg.train_dataset}: {len(dataset)} records make "
                         f"no batch of {cfg.batch_size}")
    test_loader = None
    if cfg.test_dataset:
        test_ds = CXRPretrainDataset(cfg.test_dataset, tokenizer, cfg,
                                     seed=cfg.seed + 1)
        test_loader = BatchLoader(test_ds, cfg.batch_size, shuffle=False)
        eval_step = make_eval_step(cfg)
    state = init_state(cfg, device=device)
    generator = torch.Generator().manual_seed(cfg.seed)
    _initialize(args, cfg, state, generator, logger)
    start_epoch, skip = _resume(cfg, state, generator, loader, logger)
    # a consumed mid-epoch marker left epoch start_epoch's files holding a
    # mid-epoch state: that epoch's end overwrites them whatever
    # --save_interval says
    force_save_epoch = start_epoch if skip else -1
    k = max(1, args.steps_per_dispatch)
    train_step = make_train_step(cfg)
    multi_step = MultiStep(train_step, k)
    metrics_path = os.path.join(cfg.output_path, "metrics.jsonl")
    rows: List[dict] = []

    def save(epoch: int, in_epoch: bool = False) -> None:
        t0 = time.perf_counter()
        paths = ckpt.save_training_state(cfg.output_path, epoch, state,
                                         generator, loader, in_epoch)
        logger.info("saved %s in %.2f s", " and ".join(paths),
                    time.perf_counter() - t0)

    guard = preempt.PreemptionGuard(logger=logger)
    try:
        with guard:
            for epoch in range(start_epoch, cfg.epochs):
                t0 = time.perf_counter()
                agg: Dict[str, List[torch.Tensor]] = {}
                done = skip if epoch == start_epoch else 0
                batches = iter(dispatch_loader(loader, device, k=k))
                trace = None
                for i, (batch, is_group) in enumerate(batches):
                    if args.profile_dir and epoch == 0 and i == 2:
                        trace = _start_trace(device)
                    m = (multi_step if is_group else train_step)(
                        state, batch, generator)
                    done += k if is_group else 1
                    if guard.triggered:
                        # the step ends, the prefetch stops; the batches it
                        # loaded ahead are dropped: the marker counts the
                        # trained ones
                        if device.type == "cuda":
                            torch.cuda.synchronize(device)
                        batches.close()
                        if trace is not None:
                            _stop_trace(trace, device, args.profile_dir,
                                        logger)
                        save(epoch, in_epoch=True)
                        preempt.write_marker(cfg.output_path, epoch, done)
                        logger.info("preempted (signal %s): saved epoch %d "
                                    "at host batch %d to %s; relaunch to "
                                    "resume", guard.signum, epoch, done,
                                    cfg.output_path)
                        return rows
                    if trace is not None and i == 4:
                        _stop_trace(trace, device, args.profile_dir, logger)
                        trace = None
                    collect_metrics(agg, m, is_group)
                    if i % cfg.log_freq == 0:
                        logger.info("epoch %d it %d loss %.4f", epoch, i * k,
                                    m["loss"].float().reshape(-1)[-1].item())
                    if args.watch_interval and i % args.watch_interval == 0:
                        # off the hot path: one read of the device
                        with open(os.path.join(cfg.output_path,
                                               WATCH_FILE), "a") as f:
                            f.write(json.dumps(dict(
                                watch_norms(state.model, state.tx),
                                epoch=epoch, step=epoch * 10 ** 6 + i * k))
                                + "\n")
                if trace is not None:
                    _stop_trace(trace, device, args.profile_dir, logger)
                row = _epoch_row(agg)  # reads the device: the epoch ended
                row.update(epoch=epoch,
                           epoch_time_s=time.perf_counter() - t0)
                row["pairs_per_s"] = (row["micro_steps"] * cfg.batch_size
                                      / row["epoch_time_s"])
                if test_loader is not None:
                    row.update(_evaluate(eval_step, state, test_loader,
                                         test_ds, cfg.seed + 1, device))
                rows.append(row)
                logger.info("epoch %d done: %s", epoch, row)
                with open(metrics_path, "a") as f:
                    f.write(json.dumps(row) + "\n")
                save_now = ((epoch + 1) % max(1, args.save_interval) == 0
                            or epoch + 1 == cfg.epochs
                            or epoch == force_save_epoch)
                if save_now:
                    save(epoch)
                if guard.triggered and epoch + 1 < cfg.epochs:
                    # preempted in the eval or the save: the epoch is done
                    if not save_now:
                        save(epoch)
                    preempt.write_marker(cfg.output_path, epoch, len(loader))
                    logger.info("preempted (signal %s) at the end of epoch "
                                "%d; relaunch to resume at epoch %d",
                                guard.signum, epoch, epoch + 1)
                    return rows
    finally:
        loader.close()
    return rows


def main(argv=None) -> List[dict]:
    return train(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
