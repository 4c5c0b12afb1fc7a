"""Disease-classification CLI of the port (the counterpart of
medvill_tpu/cli/classification_main.py, with its flag names and defaults;
reference: Downstream_task/Classification/mmbt/main.py:23-91,196-403).

    python -m medvill_torch.cli.classification_main --data_path DIR \
        --vocab_file vocab.txt [--loaddir pretrain_dir] [--do_test true] \
        [--device cuda]

It reads ``<data_path>/Train.jsonl`` and ``Valid.jsonl`` (records with
``text``, ``label``, ``img``), takes the label vocabulary and the BCE
``pos_weight`` from the train split, builds the MMBT model (random weights
from ``--seed``; BERT-base and the ResNet-50 trunk at 512 px with 256
fibers by default; the pool encoder for ``--num_image_embeds`` 1-9) and,
with ``--loaddir``, merges the latest pretrain ``model.<epoch>.bin`` of
that directory (``checkpoint.merge_pretrained_into_mmbt``: every ``enc.*``
tensor whose name and shape match, BatchNorm statistics included; a
directory with none raises).  Each epoch trains through the prefetching
loader (``dispatch_loader``; with ``--steps_per_dispatch k`` > 1, k
micro-steps per dispatch over groups of k batches: CUDA graphs on the
card, captured again for each freeze phase, a loop of eager steps on the
CPU; an epoch's tail batches train alone) under the epoch's freeze phase (``--freeze_img``
/ ``--freeze_txt`` epochs; ``--freeze_*_all false`` freezes for the whole
run), evaluates the valid split (AUROC/F1, or accuracy with ``--task_type
classification``), moves the plateau scale, writes ``<savedir>/<name>/
<name>.csv``, ``model.<epoch>.bin`` in the reference MMBT layout
(``convert.load_mmbt_checkpoint`` reads it) and, when the tuning metric
improved, ``model.best.bin``, and appends a row to ``metrics.jsonl``
(valid metrics, ``train_loss``, ``epoch_time_s`` and ``examples_per_s`` =
micro-steps x batch / epoch time).  It stops after ``--patience`` epochs
without improvement.  ``--do_test`` restores ``model.best.bin`` and
evaluates ``Test.jsonl``.

``--bert_init_path`` (an HF BERT file into ``enc``) and
``--resnet_init_path`` (a torchvision ResNet-50 file into the trunk)
initialize the model before the ``--loaddir`` merge, in the JAX CLI's
order (``torch_init``).

Preemption (``utils/preempt.py``, save-only as in JAX :253-291): SIGTERM
is read after every dispatch; the CLI then writes the epoch's
``model.<epoch>.bin`` as an epoch's end does and returns (exit 0) with
the epochs done.  A relaunch starts afresh: a classification run is short
and early-stopped, so there is no position to resume.

It runs on the card unless ``--device cpu`` is given, and raises on a host
without one.  Not ported (ROADMAP.md): the mesh/parallelism flags (with
them ``global_any``, whose agreement JAX polls every
``preempt.POLL_EVERY`` batches); argparse rejects them like any unknown
flag.
"""
from __future__ import annotations

import argparse
import csv
import json
import os
import shutil
import time
from typing import Dict, List

import numpy as np
import torch

from medvill_torch import torch_init
from medvill_torch.checkpoint import (latest_pretrain_file,
                                      merge_pretrained_into_mmbt)
from medvill_torch.cli import collect_metrics, make_tokenizer, str2bool
from medvill_torch.config import (BertConfig, ClassificationConfig,
                                  ImageEncoderConfig)
from medvill_torch.convert import load_mmbt_checkpoint
from medvill_torch.data.classification import (ClassificationDataset,
                                               get_labels_and_frequencies,
                                               pos_weights)
from medvill_torch.data.pretrain import BatchLoader, dispatch_loader
from medvill_torch.train import classify
from medvill_torch.train.dispatch import MultiStep
from medvill_torch.utils import preempt
from medvill_torch.utils.device import resolve_device
from medvill_torch.utils.logging import create_logger
from medvill_torch.utils.seed import set_seed


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--data_path", type=str, required=True)
    p.add_argument("--Train_dset_name", type=str, default="Train.jsonl")
    p.add_argument("--Valid_dset_name", type=str, default="Valid.jsonl")
    p.add_argument("--vocab_file", type=str, required=True)
    p.add_argument("--savedir", type=str, default="output_clf")
    p.add_argument("--loaddir", type=str, default="",
                   help="a directory of pretrain model.<epoch>.bin files; "
                        "the latest epoch is merged")
    p.add_argument("--save_name", "--name", dest="save_name", type=str,
                   default="clf",
                   help="run name (reference --name, mmbt/main.py:45)")
    p.add_argument("--model", type=str, default="mmbt", choices=["mmbt"])
    p.add_argument("--task_type", type=str, default="multilabel",
                   choices=["multilabel", "classification"],
                   help="multilabel: weighted BCE + AUROC/F1; "
                        "classification: softmax CE + accuracy")
    p.add_argument("--freeze_img_all", type=str2bool, default=True,
                   help="False freezes the image encoder for the whole run "
                        "(the reference assigns this to requires_grad, "
                        "mmbt/main.py:204-206)")
    p.add_argument("--freeze_txt_all", type=str2bool, default=True,
                   help="False freezes the text encoder for the whole run "
                        "(mmbt/main.py:208-209)")
    p.add_argument("--n_workers", type=int, default=1,
                   help="loader worker threads; <=1 draws from one "
                        "sequential stream")
    p.add_argument("--openi", type=str2bool, default=False)
    p.add_argument("--batch_sz", type=int, default=56)
    p.add_argument("--max_epochs", type=int, default=10)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--lr_factor", type=float, default=0.5)
    p.add_argument("--lr_patience", type=int, default=2)
    p.add_argument("--patience", type=int, default=10)
    p.add_argument("--warmup", type=float, default=0.1)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--max_seq_len", type=int, default=512)
    p.add_argument("--num_image_embeds", type=int, default=256)
    p.add_argument("--img_embed_pool_type", type=str, default="avg",
                   choices=["avg", "max"],
                   help="adaptive pool type for num_image_embeds 1-9 "
                        "(reference: mmbt/models/image.py:24-39)")
    p.add_argument("--img_size", type=int, default=512)
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--freeze_img", type=int, default=0)
    p.add_argument("--freeze_txt", type=int, default=0)
    p.add_argument("--weight_classes", type=str2bool, default=True)
    p.add_argument("--drop_img_percent", type=float, default=0.0)
    p.add_argument("--bert_model", type=str, default="bert-base-scratch")
    p.add_argument("--vocab_size", type=int, default=30522)
    p.add_argument("--do_test", type=str2bool, default=False)
    p.add_argument("--Test_dset_name", type=str, default="Test.jsonl")
    p.add_argument("--bert_init_path", type=str, default=None,
                   help="HF BERT torch .bin to initialize the text encoder "
                        "(reference: mmbt BertModel.from_pretrained)")
    p.add_argument("--resnet_init_path", type=str, default=None,
                   help="torchvision resnet50 .pth to initialize the image "
                        "encoder (reference: mmbt/models/image.py "
                        "pretrained=True)")
    p.add_argument("--steps_per_dispatch", type=int, default=1,
                   help="train micro-steps per dispatch (CUDA graphs "
                        "replayed over stacked batches; the JAX CLI's "
                        "lax.scan) — amortizes per-dispatch host/runtime "
                        "overhead; no reference equivalent")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def config_from_args(args, labels) -> ClassificationConfig:
    """``--freeze_*_all false`` freezes for every epoch (the reference's
    inverted requires_grad assignment)."""
    freeze_img = args.freeze_img if args.freeze_img_all else args.max_epochs
    freeze_txt = args.freeze_txt if args.freeze_txt_all else args.max_epochs
    return ClassificationConfig(
        bert=BertConfig.from_name(args.bert_model, args.vocab_size),
        task_type=args.task_type, data_path=args.data_path,
        batch_size=args.batch_sz, max_epochs=args.max_epochs, lr=args.lr,
        lr_factor=args.lr_factor, lr_patience=args.lr_patience,
        patience=args.patience, warmup=args.warmup,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        max_seq_len=args.max_seq_len,
        num_image_embeds=args.num_image_embeds, img_size=args.img_size,
        seed=args.seed, freeze_img=freeze_img, freeze_txt=freeze_txt,
        weight_classes=args.weight_classes, labels=tuple(labels),
        image=ImageEncoderConfig(
            num_image_embeds=args.num_image_embeds, img_size=args.img_size,
            # the 1-9-embed configs pool the trunk's map (the reference's
            # adaptive-pool table); larger counts take its fibers
            encoder="pool" if args.num_image_embeds <= 9 else "full-fiber",
            pool_type=args.img_embed_pool_type))


def _write_csv(path: str, metrics: dict, task_type: str) -> None:
    """The reference's per-epoch CSV (mmbt/main.py:307-317)."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        if task_type == "multilabel":
            per_class = metrics["per_class_auroc"]
            w.writerow(["micro_auc", "macro_auc", "micro_f1", "macro_f1"]
                       + list(per_class))
            w.writerow([metrics["micro_roc_auc"], metrics["macro_roc_auc"],
                        metrics["micro_f1"], metrics["macro_f1"]]
                       + list(per_class.values()))
        else:
            w.writerow(["acc"])
            w.writerow([metrics["acc"]])


def train(args) -> dict:
    """Runs the epochs and the test; returns {"epochs": one row per epoch,
    "test": the test metrics or None, "merged": the keys merged from
    --loaddir}."""
    device = resolve_device(args.device)
    set_seed(args.seed)
    savedir = os.path.join(args.savedir, args.save_name)
    os.makedirs(savedir, exist_ok=True)
    logger = create_logger(os.path.join(savedir, "logfile.log"), args)
    tokenizer = make_tokenizer(args.vocab_file, remap_unused=False)
    train_path = os.path.join(args.data_path, args.Train_dset_name)
    labels, freqs = get_labels_and_frequencies(train_path)
    cfg = config_from_args(args, labels)

    def dataset(path, **kw):
        return ClassificationDataset(
            path, tokenizer, labels, cfg.max_seq_len, cfg.num_image_embeds,
            cfg.img_size, openi=args.openi, task_type=cfg.task_type, **kw)

    train_ds = dataset(train_path, drop_img_percent=args.drop_img_percent)
    valid_ds = dataset(os.path.join(args.data_path, args.Valid_dset_name))
    train_loader = BatchLoader(train_ds, cfg.batch_size, shuffle=True,
                               seed=cfg.seed, workers=args.n_workers)
    valid_loader = BatchLoader(valid_ds, cfg.batch_size, shuffle=False,
                               drop_last=False, workers=args.n_workers)
    # the schedule counts the dataset, not the loader (mmbt/main.py:125)
    t_total = max(1, int(len(train_ds) / cfg.batch_size
                         / cfg.gradient_accumulation_steps * cfg.max_epochs))
    pw = None
    if cfg.weight_classes and cfg.task_type == "multilabel":
        pw = torch.from_numpy(pos_weights(freqs, labels,
                                          len(train_ds))).to(device)
    state = classify.init_state(cfg, len(labels), t_total, device=device)
    if args.bert_init_path:
        torch_init.init_bert_from_torch(
            state.model, args.bert_init_path, enc_key="enc",
            num_layers=cfg.bert.num_hidden_layers)
        logger.info("initialized text encoder from %s", args.bert_init_path)
    if args.resnet_init_path:
        torch_init.init_resnet_from_torch(
            state.model, args.resnet_init_path,
            trunk_path=("enc", "img_encoder"))
        logger.info("initialized image encoder from %s",
                    args.resnet_init_path)
    merged: List[str] = []
    if args.loaddir:
        path = latest_pretrain_file(args.loaddir)
        merged = merge_pretrained_into_mmbt(state.model, path)
        logger.info("merged %d tensors from %s", len(merged), path)
    cls_id, sep_id = tokenizer.vocab["[CLS]"], tokenizer.vocab["[SEP]"]
    train_step = classify.make_train_step(cfg, pw, cls_id, sep_id)
    multi_step = MultiStep(train_step, max(1, args.steps_per_dispatch))
    eval_step = classify.make_eval_step(cfg, cls_id, sep_id)
    sched = classify.PlateauScheduler(cfg.lr_factor, cfg.lr_patience)
    generator = torch.Generator().manual_seed(cfg.seed)
    metrics_path = os.path.join(savedir, "metrics.jsonl")
    best_path = os.path.join(savedir, "model.best.bin")
    best_metric, n_no_improve = -np.inf, 0
    rows: List[dict] = []

    def save(epoch: int) -> str:
        path = os.path.join(savedir, f"model.{epoch}.bin")
        torch.save({k: v.detach().cpu() for k, v in
                    state.model.state_dict().items()}, path)
        return path

    try:
        with preempt.PreemptionGuard(logger=logger) as guard:
            for epoch in range(cfg.max_epochs):
                classify.apply_freeze(state.model, epoch < cfg.freeze_img,
                                      epoch < cfg.freeze_txt)
                t0 = time.perf_counter()
                agg: Dict[str, List[torch.Tensor]] = {}
                for batch, is_group in dispatch_loader(train_loader, device,
                                                       k=multi_step.k):
                    m = (multi_step if is_group else train_step)(
                        state, batch, generator)
                    collect_metrics(agg, m, is_group)
                    if guard.triggered:
                        # save-only (JAX :253-291): a run is short and
                        # early-stopped, so it keeps the work, no position
                        path = save(epoch)
                        logger.info("preempted (signal %s): saved %s",
                                    guard.signum, path)
                        return {"epochs": rows, "test": None,
                                "merged": merged}
                losses = agg["loss"]
                train_loss = torch.stack(losses).float().mean().item()
                epoch_s = time.perf_counter() - t0
                metrics, _, _ = classify.evaluate(eval_step, state.model,
                                                  valid_loader,
                                                  cfg.task_type)
                row: Dict = dict(metrics, epoch=epoch,
                                 train_loss=train_loss,
                                 micro_steps=len(losses),
                                 epoch_time_s=epoch_s,
                                 examples_per_s=len(losses) * cfg.batch_size
                                 / epoch_s)
                tuning = (metrics["micro_f1"]
                          if cfg.task_type == "multilabel"
                          else metrics["acc"])
                state.tx.optimizer.plateau = sched.step(tuning)
                improved = tuning > best_metric
                if improved:
                    best_metric, n_no_improve = tuning, 0
                else:
                    n_no_improve += 1
                row.update(lr_scale=state.tx.optimizer.plateau,
                           improved=bool(improved))
                rows.append(row)
                logger.info("epoch %d: %s", epoch, row)
                with open(metrics_path, "a") as f:
                    f.write(json.dumps(row) + "\n")
                _write_csv(os.path.join(savedir, f"{args.save_name}.csv"),
                           metrics, cfg.task_type)
                path = save(epoch)
                if improved:
                    shutil.copyfile(path, best_path)
                if n_no_improve >= cfg.patience:
                    logger.info("No improvement. Breaking out of loop.")
                    break
    finally:
        train_loader.close()
        valid_loader.close()
    test = None
    if args.do_test:
        if os.path.exists(best_path):
            load_mmbt_checkpoint(state.model, best_path)
            logger.info("loaded %s for test", best_path)
        test_loader = BatchLoader(
            dataset(os.path.join(args.data_path, args.Test_dset_name)),
            cfg.batch_size, shuffle=False, drop_last=False)
        test, _, _ = classify.evaluate(eval_step, state.model, test_loader,
                                       cfg.task_type)
        logger.info("test: %s", test)
        with open(metrics_path, "a") as f:
            f.write(json.dumps({"test": test}) + "\n")
    return {"epochs": rows, "test": test, "merged": merged}


def main(argv=None) -> dict:
    return train(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
