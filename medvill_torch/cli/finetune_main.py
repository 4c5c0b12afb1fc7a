"""Report-generation / VQA finetune CLI of the port (the counterpart of
medvill_tpu/cli/finetune_main.py, with its flag names and defaults;
reference: sc/finetune.py:49-495).

    python -m medvill_torch.cli.finetune_main --src_file train.jsonl \
        --vocab_file vocab.txt --model_recover_path pretrain/model.0.bin \
        [--tasks vqa --vqa_eval true] [--device cuda]

It builds the VLP model (random weights from ``--seed``), recovers a
pretrain checkpoint in the CXRBERT layout when ``--model_recover_path`` is
given (``medvill_torch.checkpoint.recover_pretrain_into_vlp``: the keys the
file lacks keep their random init and are logged), and runs
``--num_train_epochs`` over ``BatchLoader`` (prefetched and placed on the
device on a background thread, ``dispatch_loader``) -> the train step of
``medvill_torch.train.finetune``, or with ``--steps_per_dispatch k`` > 1 its
k-micro-step dispatch over groups of k batches (CUDA graphs on the card, a
loop of eager steps on the CPU; an epoch's tail batches train alone; a
new step when the drop-worst ratio changes, where JAX compiles one, and
the last ratio's graphs dropped, since the ratio never goes back)
(BertAdam over ``t_total = max(1,
len(loader) * epochs // accumulation)`` optimizer steps, drop-worst from
the epoch after ``--drop_after``).  At the end of each epoch it writes
``<output_dir>/model.<epoch>.bin`` in the reference VLP layout (what
``medvill_torch.convert.load_vlp_checkpoint`` and the serve CLI read) with
``optim.<epoch>.bin``, the rest of the training state
(``checkpoint.save_training_state``), and appends the epoch's metrics to
``<output_dir>/metrics.jsonl``; it writes the arguments to ``opt.json``.
With ``--tasks vqa --vqa_eval true`` it ends with the open/closed accuracy
on the test split.

``--bert_init_path`` (an HF BERT file, ``torch_init.init_bert_from_torch``
into the encoder) and ``--resnet_init_path`` (a torchvision ResNet-50 file,
``torch_init.init_resnet_from_torch`` into the trunk) initialize the model
before the recover, in the JAX CLI's order.

Resume (medvill_tpu/cli/finetune_main.py:276-335,368-425): a relaunch
into an ``--output_dir`` that holds a saved epoch N restores the whole
training state and goes on at N + 1 (the recover is skipped), or, where a
preemption marker names N, re-enters N at the marker's batch
(``BatchLoader.skip_next``).  SIGTERM is read after every dispatch: the
step ends, the state is saved under the epoch with a marker of the host
batches trained, and the process returns (exit 0).

Scale-out (``parallel.py``), as in the pretrain CLI: under ``torchrun``
each rank reads its shard of the records (``--train_batch_size`` per
process), ``--model_parallel`` and ``--zero1`` lay the model and the
BertAdam moments out over the ranks, drop-worst keeps the global batch's
best, rank 0 writes, and SIGTERM on any rank stops every rank at the same
dispatch.

It runs on the card unless ``--device cpu`` is given, and raises on a host
without one.  Not ported (ROADMAP.md): an orbax directory as
``--model_recover_path``; argparse rejects it like any unknown flag.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Dict, List, Optional

import torch

from medvill_torch import checkpoint as ckpt
from medvill_torch import torch_init
from medvill_torch.checkpoint import recover_pretrain_into_vlp
from medvill_torch import parallel
from medvill_torch.cli import (add_parallelism_args, collect_metrics,
                               make_tokenizer, str2bool)
from medvill_torch.config import (BertConfig, FinetuneConfig,
                                  ImageEncoderConfig)
from medvill_torch.data.pretrain import BatchLoader, dispatch_loader
from medvill_torch.data.seq2seq import Img2TxtDataset
from medvill_torch.data.vqa import VQADataset
from medvill_torch.train import finetune as ft
from medvill_torch.train.dispatch import MultiStep
from medvill_torch.utils import preempt
from medvill_torch.utils.device import resolve_device
from medvill_torch.utils.logging import create_logger
from medvill_torch.utils.seed import set_seed

# the batch keys the train step reads
_KEYS = ("image", "input_ids", "segment_ids", "mask_spec", "masked_ids",
         "masked_pos", "masked_weights", "ans_target", "task_idx")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--tasks", type=str, default="report_generation",
                   choices=["report_generation", "vqa"])
    p.add_argument("--src_file", type=str, required=True,
                   help="report-gen: train JSONL; vqa: VQA-RAD dataroot")
    p.add_argument("--image_root", type=str, default="")
    p.add_argument("--vocab_file", type=str, required=True)
    p.add_argument("--output_dir", type=str, default="output_finetune")
    p.add_argument("--model_recover_path", type=str, default=None,
                   help="a pretrain checkpoint file in the CXRBERT layout")
    p.add_argument("--train_batch_size", type=int, default=4)
    p.add_argument("--num_train_epochs", type=int, default=5)
    p.add_argument("--learning_rate", type=float, default=3e-5)
    p.add_argument("--warmup_proportion", type=float, default=0.1)
    p.add_argument("--weight_decay", type=float, default=0.01)
    p.add_argument("--label_smoothing", type=float, default=0.1)
    p.add_argument("--drop_prob", type=float, default=0.1,
                   help="model dropout: sets both the attention and the "
                        "hidden rate (reference model.py:620-623)")
    p.add_argument("--max_drop_worst_ratio", type=float, default=0.0,
                   help="Ruotian-Luo drop-worst ratio (reference "
                        "finetune.py:179; 0 = off, the reference default)")
    p.add_argument("--drop_after", type=int, default=6,
                   help="drop-worst is on once the 1-based epoch exceeds "
                        "this (reference finetune.py:180,440)")
    p.add_argument("--trunc_seg", type=str, default="b",
                   choices=["a", "b", ""],
                   help="segment to truncate when neither cap is exceeded "
                        "(reference finetune.py:158)")
    p.add_argument("--always_truncate_tail", action="store_true",
                   help="always pop the tail instead of head or tail at "
                        "50%% (reference finetune.py:160)")
    p.add_argument("--sche_mode", type=str, default="warmup_linear",
                   choices=["warmup_linear", "warmup_constant",
                            "warmup_cosine"],
                   help="BertAdam lr schedule (reference finetune.py:175)")
    p.add_argument("--from_scratch", action="store_true",
                   help="ignore --model_recover_path and train from random "
                        "init (reference finetune.py:314)")
    p.add_argument("--do_train", type=str2bool, default=True,
                   help="false skips training (eval only with --vqa_eval; "
                        "reference finetune.py:101,260,410)")
    p.add_argument("--data_set", type=str, default="train",
                   choices=["train", "valid"],
                   help="'valid' reads --file_valid_jpgs instead of "
                        "--src_file (reference data_loader.py:217-224)")
    p.add_argument("--file_valid_jpgs", type=str, default=None)
    p.add_argument("--config_path", type=str, default=None,
                   help="reference-style config.json overlaying the BERT "
                        "config (reference finetune.py:319)")
    p.add_argument("--max_position_embeddings", type=int, default=512)
    p.add_argument("--num_workers", type=int, default=1,
                   help="loader worker threads (reference DataLoader "
                        "num_workers, finetune.py:284-286)")
    p.add_argument("--log_file", type=str, default="training.log",
                   help="log file name under output_dir (reference "
                        "finetune.py:223)")
    p.add_argument("--max_pred", type=int, default=128)
    p.add_argument("--mask_prob", type=float, default=0.15)
    p.add_argument("--len_vis_input", type=int, default=256)
    p.add_argument("--max_len_b", type=int, default=253)
    p.add_argument("--max_seq_length", type=int, default=512)
    p.add_argument("--new_segment_ids", type=str2bool, default=True)
    p.add_argument("--s2s_prob", type=float, default=1.0)
    p.add_argument("--bi_prob", type=float, default=0.0)
    p.add_argument("--bar", type=str2bool, default=False)
    p.add_argument("--vqa_rad", type=str, default="chest",
                   choices=["all", "chest", "head", "abd"])
    p.add_argument("--img_size", type=int, default=512)
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--vqa_eval", type=str2bool, default=False)
    p.add_argument("--bert_model", type=str, default="bert-base-scratch")
    p.add_argument("--vocab_size", type=int, default=30522)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--bert_init_path", type=str, default=None,
                   help="HF BERT torch .bin to initialize the VLP encoder "
                        "(reference: from_pretrained in finetune.py)")
    p.add_argument("--resnet_init_path", type=str, default=None,
                   help="torchvision resnet50 .pth for the visual trunk")
    p.add_argument("--relax_projection", action="store_true",
                   help="4 task-specific MLM-head projections selected by "
                        "task_idx (reference: finetune.py:182,307-319)")
    p.add_argument("--steps_per_dispatch", type=int, default=1,
                   help="k train micro-steps per dispatch (CUDA graphs "
                        "replayed over stacked batches; the JAX CLI's "
                        "lax.scan) — amortizes per-dispatch host overhead; "
                        "same mechanism as the pretrain CLI's flag")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    add_parallelism_args(p)
    return p


def config_from_args(args) -> FinetuneConfig:
    """``--config_path`` overlays the BERT config first, then
    ``--drop_prob`` sets both dropout rates and a non-default
    ``--max_position_embeddings`` wins (reference finetune.py:307-320)."""
    bert = BertConfig.vlp(BertConfig.from_name(args.bert_model,
                                               args.vocab_size),
                          new_segment_ids=args.new_segment_ids)
    if args.relax_projection:
        bert = dataclasses.replace(bert, relax_projection=4)
    if args.config_path:
        bert = BertConfig.from_reference_json(args.config_path, base=bert)
    bert = dataclasses.replace(
        bert, hidden_dropout_prob=args.drop_prob,
        attention_probs_dropout_prob=args.drop_prob)
    if args.max_position_embeddings not in (None, 512):
        bert = dataclasses.replace(
            bert, max_position_embeddings=args.max_position_embeddings)
    return FinetuneConfig(
        task=args.tasks, src_file=args.src_file, output_dir=args.output_dir,
        model_recover_path=args.model_recover_path,
        batch_size=args.train_batch_size, epochs=args.num_train_epochs,
        lr=args.learning_rate, warmup=args.warmup_proportion,
        weight_decay=args.weight_decay,
        label_smoothing=args.label_smoothing, drop_prob=args.drop_prob,
        max_drop_worst_ratio=args.max_drop_worst_ratio,
        drop_after=args.drop_after, trunc_seg=args.trunc_seg or None,
        always_truncate_tail=args.always_truncate_tail,
        sche_mode=args.sche_mode, max_pred=args.max_pred,
        mask_prob=args.mask_prob, len_vis_input=args.len_vis_input,
        max_len_b=args.max_len_b, max_seq_length=args.max_seq_length,
        new_segment_ids=args.new_segment_ids, s2s_prob=args.s2s_prob,
        bi_prob=args.bi_prob, bar=args.bar,
        vqa_organs=((args.vqa_rad,) if args.vqa_rad != "all" else
                    ("chest", "head", "abd")),
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        img_size=args.img_size, seed=args.seed, bert=bert,
        image=ImageEncoderConfig(num_image_embeds=args.len_vis_input,
                                 img_size=args.img_size,
                                 encoder="full-fiber"))


def _epoch_row(agg: Dict[str, List[torch.Tensor]]) -> dict:
    row = {k: torch.stack(v).float().mean().item() for k, v in agg.items()}
    if "batch_score" in agg:
        row["train_acc"] = (torch.stack(agg["batch_score"]).sum().item()
                            / torch.stack(agg["n"]).sum().item())
    row["micro_steps"] = len(agg["loss"])
    return row


def _resume(cfg: FinetuneConfig, state, generator, loader,
            logger) -> Optional[tuple]:
    """(first epoch, host batches of it to skip), or None for a fresh run:
    resume-by-scan of
    ``--output_dir`` (medvill_tpu/cli/finetune_main.py:276-335; reference
    finetune.py:37-47): the latest epoch N with both files restores the
    whole training state and the run goes on at N + 1, or, where a
    preemption marker names N, re-enters N at the marker's batch."""
    recover = ckpt.latest_epoch(cfg.output_dir)
    if recover is None:
        return None
    ckpt.restore_training_state(cfg.output_dir, recover, state, generator,
                                loader)
    start, skip = recover + 1, 0
    logger.info("resumed from epoch %d", recover)
    marker = preempt.read_marker(cfg.output_dir)
    if marker is not None:
        if marker["epoch"] == recover and marker["batches_done"]:
            start, skip = recover, int(marker["batches_done"])
            logger.info("preemption marker: re-entering epoch %d at host "
                        "batch %d", recover, skip)
        parallel.barrier()  # every rank has read the marker
        preempt.clear_marker(cfg.output_dir)
    return loader.resume_at(start, skip)


def train(args) -> dict:
    """Runs the epochs and the VQA eval; returns {"epochs": one metrics row
    per epoch, "vqa_eval": the eval's accuracies or None}."""
    device = parallel.initialize(resolve_device(args.device))
    set_seed(args.seed)
    if args.from_scratch:
        args.model_recover_path = None
    cfg = config_from_args(args)
    parallel.configure(args.model_parallel, cfg.bert.num_attention_heads)
    main_rank = parallel.is_main()
    os.makedirs(cfg.output_dir, exist_ok=True)
    logger = create_logger(os.path.join(cfg.output_dir, args.log_file), args)
    if main_rank:
        with open(os.path.join(cfg.output_dir, "opt.json"), "w") as f:
            json.dump(vars(args), f, indent=2)
    tokenizer = make_tokenizer(args.vocab_file, remap_unused=True)
    if cfg.task == "vqa":
        ds = VQADataset(cfg, tokenizer, args.src_file, split="train",
                        image_root=args.image_root, seed=cfg.seed)
    else:
        src = args.src_file
        if args.data_set == "valid" and args.file_valid_jpgs:
            src = args.file_valid_jpgs
        ds = Img2TxtDataset(src, tokenizer, cfg, seed=cfg.seed)
    loader = BatchLoader(ds, cfg.batch_size, shuffle=True, seed=cfg.seed,
                         workers=args.num_workers,
                         **parallel.loader_shards())
    t_total = max(1, len(loader) * cfg.epochs
                  // cfg.gradient_accumulation_steps)
    state = ft.init_state(cfg, t_total, device=device)
    if args.bert_init_path:
        torch_init.init_bert_from_torch(
            state.model, args.bert_init_path, enc_key="bert",
            num_layers=cfg.bert.num_hidden_layers)
        logger.info("initialized encoder from %s", args.bert_init_path)
    if args.resnet_init_path:
        torch_init.init_resnet_from_torch(
            state.model, args.resnet_init_path,
            trunk_path=("bert", "img_encoder"))
        logger.info("initialized visual trunk from %s",
                    args.resnet_init_path)
    generator = torch.Generator().manual_seed(cfg.seed)
    resumed = _resume(cfg, state, generator, loader, logger)
    start_epoch, skip = resumed or (0, 0)
    if resumed is None and cfg.model_recover_path:
        loaded, missing = recover_pretrain_into_vlp(state.model,
                                                    cfg.model_recover_path)
        logger.info("recovered %d tensors from %s", len(loaded),
                    cfg.model_recover_path)
        if missing:
            logger.info("%d keys keep their random init: %s", len(missing),
                        missing)
    parallel.place(state, args.zero1)
    metrics_path = os.path.join(cfg.output_dir, "metrics.jsonl")
    k = max(1, args.steps_per_dispatch)
    step = multi = ratio_of_multi = None
    rows = []

    def save(epoch: int, in_epoch: bool = False) -> None:
        t0 = time.perf_counter()
        paths = ckpt.save_training_state(cfg.output_dir, epoch, state,
                                         generator, loader, in_epoch)
        logger.info("saved %s in %.2f s", " and ".join(paths),
                    time.perf_counter() - t0)

    try:
        with preempt.PreemptionGuard(logger=logger) as guard:
            for epoch in (range(start_epoch, cfg.epochs) if args.do_train
                          else ()):
                ratio = ft.drop_worst_ratio_for_epoch(cfg, epoch)
                if ratio != ratio_of_multi:
                    # the ratio never goes back: the last one's graphs go,
                    # and their memory pool back to the card
                    multi = None
                    torch.cuda.empty_cache()
                    step = ft.make_train_step(cfg, ratio)
                    multi, ratio_of_multi = MultiStep(step, k), ratio
                t0 = time.perf_counter()
                agg: Dict[str, List[torch.Tensor]] = {}
                done = skip if epoch == start_epoch else 0
                batches = iter(dispatch_loader(loader, device, keys=_KEYS,
                                               k=k))
                for batch, is_group in batches:
                    m = (multi if is_group else step)(state, batch,
                                                      generator)
                    collect_metrics(agg, m, is_group)
                    done += k if is_group else 1
                    if preempt.agreed(guard):
                        # the resume scan re-enters this epoch at this batch
                        if device.type == "cuda":
                            torch.cuda.synchronize(device)
                        batches.close()
                        save(epoch, in_epoch=True)
                        preempt.write_marker(cfg.output_dir, epoch, done)
                        logger.info("preempted (signal %s): saved epoch %d "
                                    "at host batch %d to %s; relaunch to "
                                    "resume", guard.signum, epoch, done,
                                    cfg.output_dir)
                        return {"epochs": rows, "vqa_eval": None}
                row = _epoch_row(agg)  # reads the device: the epoch ended
                row.update(epoch=epoch,
                           epoch_time_s=time.perf_counter() - t0,
                           drop_worst_ratio=ratio)
                row["examples_per_s"] = (row["micro_steps"] * cfg.batch_size
                                         * loader.num_shards
                                         / row["epoch_time_s"])
                rows.append(row)
                logger.info("epoch %d: %s", epoch, row)
                if main_rank:
                    with open(metrics_path, "a") as f:
                        f.write(json.dumps(row) + "\n")
                save(epoch)
    finally:
        loader.close()
    results = None
    if cfg.task == "vqa" and args.vqa_eval:
        test_ds = VQADataset(cfg, tokenizer, args.src_file, split="test",
                             image_root=args.image_root, seed=cfg.seed)
        results = ft.vqa_evaluate(
            ft.make_vqa_eval_step(cfg), state,
            BatchLoader(test_ds, cfg.batch_size, shuffle=False,
                        drop_last=False))
        logger.info("vqa eval: %s", results)
        if main_rank:
            with open(metrics_path, "a") as f:
                f.write(json.dumps({"vqa_eval": results}) + "\n")
    return {"epochs": rows, "vqa_eval": results}


def main(argv=None) -> dict:
    return train(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
