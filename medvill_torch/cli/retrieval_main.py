"""Retrieval CLI of the port (the counterpart of
medvill_tpu/cli/retrieval_main.py:43-320, with its flag names and
defaults; reference: Downstream_task/Retrieval/full_dset_retrieval.py:
512-793).

    python -m medvill_torch.cli.retrieval_main --train_dataset train.jsonl \
        --vocab_file vocab.txt --load_pretrained_model pretrain_run \
        [--eval_during_training true --label_conditioned_valid_dataset V] \
        [--do_test true --label_conditioned_test_dataset T] [--device cuda]

The CXRBERT branch (the default) builds the pretraining model (BERT-base,
the ResNet-50 trunk frozen at 512 px, 180 random-pixel embeds, seq_len 253
so L = 436, random weights from ``--seed``) and, with
``--load_pretrained_model``, loads a torch CXRBERT checkpoint
(``checkpoint.restore_pretrained`` through
``torch_init.init_cxrbert_from_torch``: a ``.bin`` file, a directory with
``pytorch_model.bin``, or a directory of the port's pretrain or retrieval
run, whose latest ``model.<epoch>.bin`` it reads).  Each of ``--epochs``
shuffles the records by numpy's ``default_rng(seed + epoch)`` and takes
``len // batch_size`` batches of label-conditioned (positive, negative)
pairs (``data/retrieval.py``), 2 x ``--batch_size`` rows each, through the
prefetching loader (``dispatch_loader``) into ``train/retrieve.py``'s step
(AdamW at ``--lr``; K1/K2 under FULL on the card), or with
``--steps_per_dispatch k`` > 1 into k micro-steps per dispatch over groups
of k batches (either branch: CUDA graphs on the card, a loop of eager
steps on the CPU; an epoch's tail batches train alone).  At the end of each
epoch it writes ``<output_path>/model.<epoch>.bin`` in the reference
layout (``convert.load_cxrbert_checkpoint`` and
``--load_pretrained_model`` read it) and appends to ``metrics.jsonl``
``train_loss``, ``train_acc``, ``examples_per_s`` (2 x batch per
micro-step over the epoch's wall time) and, with
``--eval_during_training``, the valid pool's ``mrr``.  ``--do_test``
scores the test pool and writes ``eval_results.json`` (Hits@k, MRR, R/P@k).
Every evaluation appends its rank lines to ``rank_result_at_eval.json``
and its ``candidates_per_s`` (loading included) to ``metrics.jsonl``.  The
pools are ``--label_conditioned_{valid,test}_dataset`` (or, with
``--label_conditioned false``, ``--studyID_*``); ``--eval_dataset``
overrides both.  ``--CXRBERT false`` runs the CNN_BERT late-fusion
baseline instead (the trunk trained, ``torch_init.init_cnn_bert_from_torch``
for ``--load_pretrained_model``, checkpoints in the CNN_BERT layout).
SIGTERM ends training after the current micro-step with the epoch's
checkpoint saved (``utils/preempt.py``, save-only as in JAX).

Scale-out (``parallel.py``): under ``torchrun`` ``--batch_size`` stays the
global batch, as on JAX's mesh: every rank builds it and trains on its
data rank's block of rows (``parallel.local_rows``; the data ranks must
divide its 2 x ``--batch_size`` rows, as JAX's placement requires);
``--model_parallel`` and ``--zero1`` lay the model and the AdamW moments
out over the ranks;
every rank scores the whole pools (the metrics are the single-process
ones), rank 0 writes the files, and SIGTERM on any rank stops every rank
at the same batch, polled every ``preempt.POLL_EVERY`` batches.

It runs on the card unless ``--device cpu`` is given, and raises on a host
without one.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List

import numpy as np
import torch

from medvill_torch import torch_init
from medvill_torch.checkpoint import restore_pretrained
from medvill_torch import parallel
from medvill_torch.cli import (add_parallelism_args, collect_metrics,
                               make_tokenizer, str2bool)
from medvill_torch.config import (BertConfig, ImageEncoderConfig,
                                  RetrievalConfig)
from medvill_torch.data.pretrain import BatchLoader, dispatch_loader
from medvill_torch.data.retrieval import CXRRetrievalDataset, collate_pairs
from medvill_torch.train import retrieve
from medvill_torch.train.dispatch import MultiStep
from medvill_torch.utils import preempt
from medvill_torch.utils.device import resolve_device
from medvill_torch.utils.logging import create_logger
from medvill_torch.utils.seed import set_seed


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--train_dataset", type=str, default="")
    p.add_argument("--eval_dataset", type=str, default="",
                   help="explicit eval JSONL; overrides the per-protocol "
                        "flags below for both valid and test")
    # the reference selects the eval pools by protocol: label-conditioned
    # vs study-ID matching (full_dset_retrieval.py:564-585)
    p.add_argument("--label_conditioned_valid_dataset", type=str, default="")
    p.add_argument("--label_conditioned_test_dataset", type=str, default="")
    p.add_argument("--studyID_valid_dataset", type=str, default="")
    p.add_argument("--studyID_test_dataset", type=str, default="")
    p.add_argument("--MIMIC_dset", type=str2bool, default=False,
                   help="accepted for reference compatibility: rows are "
                        "read by name, so both layouts work")
    p.add_argument("--num_workers", type=int, default=1,
                   help="eval-loader worker threads (reference "
                        "full_dset_retrieval.py:572-585)")
    p.add_argument("--vocab_file", type=str, required=True)
    p.add_argument("--output_path", type=str, default="output_retrieval")
    p.add_argument("--do_train", type=str2bool, default=True)
    p.add_argument("--do_test", type=str2bool, default=False)
    p.add_argument("--eval_during_training", type=str2bool, default=False)
    p.add_argument("--i2t", type=str2bool, default=True)
    p.add_argument("--t2i", type=str2bool, default=False)
    p.add_argument("--label_conditioned", type=str2bool, default=True)
    p.add_argument("--batch_size", type=int, default=70)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--seq_len", type=int, default=253)
    p.add_argument("--num_image_embeds", type=int, default=180)
    p.add_argument("--img_size", type=int, default=512)
    p.add_argument("--img_channel", type=int, default=3, choices=[1, 3],
                   help="1 expands grayscale JPGs to 3 channels at load "
                        "(reference full_dset_retrieval.py:174-176,239-241)")
    p.add_argument("--eval_len_size", type=int, default=759)
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--load_pretrained_model", type=str, default=None)
    p.add_argument("--bert_model", type=str, default="bert-base-scratch")
    p.add_argument("--vocab_size", type=int, default=30522)
    p.add_argument("--CXRBERT", type=str2bool, default=True,
                   help="True: CXRBERT joint-encoder retrieval; False: the "
                        "late-fusion CNN_BERT baseline (reference: "
                        "full_dset_retrieval.py:656,549-555)")
    p.add_argument("--steps_per_dispatch", type=int, default=1,
                   help="train micro-steps per dispatch (CUDA graphs "
                        "replayed over stacked pos+neg pair batches; the "
                        "JAX CLI's lax.scan) — amortizes per-dispatch "
                        "host/runtime overhead; no reference equivalent")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    add_parallelism_args(p)
    return p


def config_from_args(args) -> RetrievalConfig:
    return RetrievalConfig(
        bert=BertConfig.from_name(args.bert_model, args.vocab_size),
        train_dataset=args.train_dataset, eval_dataset=args.eval_dataset,
        output_path=args.output_path, batch_size=args.batch_size,
        epochs=args.epochs, lr=args.lr, seq_len=args.seq_len,
        num_image_embeds=args.num_image_embeds, img_size=args.img_size,
        seed=args.seed, direction="i2t" if args.i2t else "t2i",
        eval_len_size=args.eval_len_size,
        pretrained_ckpt=args.load_pretrained_model,
        image=ImageEncoderConfig(num_image_embeds=args.num_image_embeds,
                                 img_size=args.img_size,
                                 img_channel=args.img_channel))


def _pools(args):
    """(valid, test) pool paths (reference full_dset_retrieval.py:564-585)."""
    if args.label_conditioned:
        valid = args.label_conditioned_valid_dataset
        test = args.label_conditioned_test_dataset
    else:
        valid, test = args.studyID_valid_dataset, args.studyID_test_dataset
    return args.eval_dataset or valid, args.eval_dataset or test


def _save(model: torch.nn.Module, path: str) -> None:
    """The model in the single-process layout, written by rank 0 (every
    rank calls it)."""
    sd = parallel.full_state_dict(model)
    if parallel.is_main():
        torch.save(sd, path)
    parallel.barrier()


def train(args) -> dict:
    """Trains and evaluates; returns {"epochs": one row per epoch, "test":
    the test results or None, "loaded": the checkpoint file read or
    None}."""
    device = parallel.initialize(resolve_device(args.device))
    set_seed(args.seed)
    cfg = config_from_args(args)
    parallel.configure(args.model_parallel, cfg.bert.num_attention_heads)
    # a batch of B pairs is 2B rows: B positives, then B negatives
    parallel.check_global_batch(2 * cfg.batch_size, "2 x --batch_size")
    main_rank = parallel.is_main()
    os.makedirs(cfg.output_path, exist_ok=True)
    logger = create_logger(os.path.join(cfg.output_path, "train.log"), args)
    tokenizer = make_tokenizer(args.vocab_file, remap_unused=False)
    cxr_bert = bool(args.CXRBERT)
    state = retrieve.init_state(cfg, cxr_bert=cxr_bert, device=device)
    loaded = None
    if cfg.pretrained_ckpt:
        # weights only: the optimizer has not stepped, so it starts fresh
        loaded = restore_pretrained(
            state.model, cfg.pretrained_ckpt,
            torch_init.init_cxrbert_from_torch if cxr_bert
            else torch_init.init_cnn_bert_from_torch, logger,
            "load_pretrained_model")
    parallel.place(state, args.zero1)
    if cxr_bert:
        train_step = retrieve.make_train_step(cfg)
        score_step = retrieve.make_score_step(cfg)
    else:
        train_step = retrieve.make_cnn_train_step(cfg)
        score_step = retrieve.make_cnn_score_step(cfg)
    multi_step = MultiStep(train_step, max(1, args.steps_per_dispatch))
    valid_path, test_path = _pools(args)
    rank_dump = os.path.join(cfg.output_path, "rank_result_at_eval.json")
    metrics_path = os.path.join(cfg.output_path, "metrics.jsonl")

    def log_row(row: dict) -> None:
        if main_rank:
            with open(metrics_path, "a") as f:
                f.write(json.dumps(row) + "\n")

    def evaluate(path: str) -> dict:
        ds = CXRRetrievalDataset(path, tokenizer, cfg, is_train=False,
                                 cxr_bert=cxr_bert)
        loader = BatchLoader(ds, cfg.batch_size, shuffle=False,
                             workers=args.num_workers, drop_last=False)
        t0 = time.perf_counter()
        try:
            res = retrieve.run_retrieval_eval(
                score_step, state.model, loader, cfg.eval_len_size,
                cfg.direction,
                rank_dump_path=rank_dump if main_rank else None,
                records=ds.data)
        finally:
            loader.close()
        res["candidates_per_s"] = len(ds) / (time.perf_counter() - t0)
        return res

    rows: List[Dict] = []
    if args.do_train:
        train_ds = CXRRetrievalDataset(
            cfg.train_dataset, tokenizer, cfg, is_train=True,
            label_conditioned=args.label_conditioned, seed=cfg.seed,
            cxr_bert=cxr_bert)
        B = cfg.batch_size
        if len(train_ds) < B:
            raise ValueError(f"{cfg.train_dataset}: {len(train_ds)} records "
                             f"make no batch of {B} pairs")

        def pair_batches(epoch: int):
            # the epoch folded into the shuffle seed, as in JAX: every epoch
            # visits a fresh order (the reference's shuffle=True)
            order = np.arange(len(train_ds))
            np.random.default_rng(cfg.seed + epoch).shuffle(order)
            for i in range(len(train_ds) // B):
                yield parallel.local_rows(collate_pairs(
                    [train_ds[int(j)] for j in order[i * B:(i + 1) * B]]))

        generator = torch.Generator().manual_seed(cfg.seed)
        with preempt.PreemptionGuard(logger=logger) as guard:
            for epoch in range(cfg.epochs):
                t0 = time.perf_counter()
                agg: Dict[str, List[torch.Tensor]] = {}
                for i, (batch, is_group) in enumerate(dispatch_loader(
                        pair_batches(epoch), device, k=multi_step.k)):
                    m = (multi_step if is_group else train_step)(
                        state, batch, generator)
                    collect_metrics(agg, m, is_group)
                    if preempt.agreed(guard, i):
                        _save(state.model, os.path.join(
                            cfg.output_path, f"model.{epoch}.bin"))
                        logger.info("preempted (signal %s): saved epoch %d "
                                    "to %s", guard.signum, epoch,
                                    cfg.output_path)
                        return {"epochs": rows, "test": None,
                                "loaded": loaded}
                losses = agg["loss"]
                row = {"epoch": epoch,
                       "train_loss": torch.stack(losses).mean().item(),
                       "train_acc": torch.stack(agg["acc"]).mean().item()}
                row["epoch_time_s"] = time.perf_counter() - t0
                row["micro_steps"] = len(losses)
                row["examples_per_s"] = (2 * B * len(losses)
                                         / row["epoch_time_s"])
                logger.info("epoch %d: %s", epoch, row)
                _save(state.model, os.path.join(cfg.output_path,
                                                f"model.{epoch}.bin"))
                if args.eval_during_training and valid_path:
                    # reference: full_dset_retrieval.py:415-458
                    res = evaluate(valid_path)
                    logger.info("epoch %d eval: %s", epoch, res)
                    row.update(mrr=res["mrr"],
                               candidates_per_s=res["candidates_per_s"])
                rows.append(row)
                log_row(row)
    test = None
    if args.do_test and test_path:
        test = evaluate(test_path)
        speed = test.pop("candidates_per_s")
        logger.info("retrieval eval: %s", test)
        if main_rank:
            with open(os.path.join(cfg.output_path, "eval_results.json"),
                      "w") as f:
                json.dump(test, f, indent=2)
        log_row({"mrr": test["mrr"],
                 **test["hits"][f"{cfg.direction}_retrieval"],
                 "candidates_per_s": speed})
        test["candidates_per_s"] = speed
    return {"epochs": rows, "test": test, "loaded": loaded}


def main(argv=None) -> dict:
    return train(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
