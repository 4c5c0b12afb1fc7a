"""Report-generation decode CLI of the port (the counterpart of
medvill_tpu/cli/decode_main.py, with its flag names and defaults; reference:
sc/generation_decode.py:112-636): batched greedy or beam decode over a test
JSONL, detokenization, ppl from the ground truth's cross-entropy, BLEU-1..4
and the CSV dumps.

    python -m medvill_torch.cli.decode_main --src_file test.jsonl \
        --vocab_file vocab.txt --model_recover_path 'run/model.*.bin' \
        [--beam_size 4 --forbid_duplicate_ngrams true] [--device cuda]

The evaluation protocol of the reference:

- ``--scenarios``: a JSON list of {dataset, model_name, src_file,
  model_recover_path, ...flag overrides} rows decoded in turn (the
  reference's hardcoded table, generation_decode.py:135-245); an unknown
  key raises;
- ``--model_recover_path`` is a glob over torch ``model.{epoch}.bin`` files
  (generation_decode.py:376); a pattern that matches nothing warns and
  decodes the random init from ``--seed``.  An orbax directory is refused:
  ``python -m medvill_tpu.cli.export_main`` converts it;
- ``--random_bootstrap_testnum`` rounds per checkpoint, each over a
  resample of the test set with replacement under ``--bootstrap_resample``
  (generation_decode.py:378,423);
- per run: ``<run>.csv`` / ``<run>_gt.csv`` (eval/bleu.py), BLEU-1..4,
  ``<run>_predictions.json``, the running best BLEU over runs, one row in
  ``metrics.jsonl``; ``all_results.json`` at the end.  Run names are
  ``{ppl}ppl_{dataset}_{model_name}_{bootstrap}test`` at beam 1 and
  ``{eval_model}{beam}beam{bootstrap}test`` above (generation_decode.py:
  594-632).  Each row also carries the decoder's wall time and its rate,
  batches x batch_size x max_txt_length tokens over that time.

Sampling (``--do_sample``) draws from one generator seeded by ``--seed`` that
advances across batches, scenarios and checkpoints, so no two batches share
noise.  It runs on the card unless ``--device cpu`` is given, and raises on
a host without one.  ``--scan_layers``/``--scan_unroll`` chose between two
XLA programs of the JAX package and have no counterpart here.
"""
from __future__ import annotations

import argparse
import dataclasses
import glob as glob_lib
import json
import math
import os
import random
import time
from typing import List, Optional

import numpy as np
import torch

from medvill_torch.cli import sampling_kwargs, serve_main, str2bool
from medvill_torch.data import images as image_lib
from medvill_torch.data.seq2seq import Seq2seqDecodePreprocessor
from medvill_torch.data.tokenization import BertTokenizer, caption_from_ids
from medvill_torch.eval.bleu import language_eval_bleu
from medvill_torch.models.decoder import (DecodeSettings, beam_search,
                                          greedy_decode)
from medvill_torch.models.seq2seq import VLPForPreTraining, init_weights
from medvill_torch.utils.device import resolve_device
from medvill_torch.utils.logging import create_logger
from medvill_torch.utils.seed import set_seed


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--src_file", type=str, default=None,
                   help="test JSONL with text+img per line")
    p.add_argument("--vocab_file", type=str, required=True)
    p.add_argument("--model_recover_path", type=str, default=None,
                   help="torch model.{epoch}.bin file; glob patterns "
                        "allowed (reference: generation_decode.py:376-410)")
    p.add_argument("--scenarios", type=str, default=None,
                   help="JSON file with a list of scenario dicts "
                        "{dataset, model_name, src_file, model_recover_path,"
                        " ...arg overrides} (generation_decode.py:135-245)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to decode on (cuda | cuda:N | cpu)")
    p.add_argument("--output_dir", type=str, default="output_decode")
    p.add_argument("--run_name", type=str, default="decode")
    p.add_argument("--eval_model", type=str, default="pretrained_",
                   help="run-name prefix for beam>1 evals "
                        "(generation_decode.py:133)")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--beam_size", type=int, default=1)
    p.add_argument("--length_penalty", type=float, default=0.0)
    p.add_argument("--forbid_duplicate_ngrams", type=str2bool, default=False)
    p.add_argument("--ngram_size", type=int, default=3)
    p.add_argument("--max_txt_length", "--max_tgt_length",
                   dest="max_txt_length", type=int, default=128,
                   help="generated-report token budget (reference "
                        "--max_txt_length, generation_decode.py:299)")
    p.add_argument("--min_len", type=int, default=0,
                   help="forbid [SEP] for the first min_len generated "
                        "positions (reference model.py:1291)")
    p.add_argument("--forbid_ignore_word", type=str, default=None,
                   help="'|'-separated words whose ids are exempt from "
                        "duplicate-ngram forbidding; [x] forms are "
                        "uppercased (generation_decode.py:351-358)")
    p.add_argument("--decode_positions", type=str, default="auto",
                   choices=["auto", "reference", "train", "global"],
                   help="text-window position ids: auto = reference for a "
                        "torch checkpoint (what the reference decoder "
                        "executes: each window at positions 0/1), train "
                        "for the random init; see DecodeSettings")
    p.add_argument("--len_vis_input", type=int, default=256)
    p.add_argument("--img_size", type=int, default=512)
    p.add_argument("--max_seq_length", type=int, default=None,
                   help="default: max_txt_length + len_vis_input + 3 "
                        "(reference generation_decode.py:328)")
    p.add_argument("--new_segment_ids", type=str2bool, default=True)
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--bert_model", type=str, default="bert-base-scratch")
    p.add_argument("--vocab_size", type=int, default=30522)
    p.add_argument("--config_path", type=str, default=None,
                   help="reference-style config.json overlaying the BERT "
                        'config, e.g. {"fused_ln": true}')
    p.add_argument("--max_position_embeddings", type=int, default=512)
    p.add_argument("--relax_projection", action="store_true",
                   help="decode a checkpoint finetuned with 4 task-specific "
                        "MLM-head projections (reference: finetune.py:307)")
    p.add_argument("--do_sample", type=str2bool, default=False,
                   help="multinomial sampling instead of argmax in the "
                        "greedy loop (reference model.py:1209-1215)")
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top_k", type=int, default=0)
    p.add_argument("--top_p", type=float, default=1.0)
    p.add_argument("--teacher_forcing", type=str2bool, default=False,
                   help="True reproduces the reference greedy loop's "
                        "gt-token feeding (model.py:1177-1189)")
    p.add_argument("--random_bootstrap_testnum", type=int, default=1,
                   help="bootstrap iterations per recovered model "
                        "(generation_decode.py:378)")
    p.add_argument("--bootstrap_resample", type=str2bool, default=False,
                   help="resample the test set with replacement each "
                        "bootstrap, as the reference always does "
                        "(generation_decode.py:423)")
    return p


def forbid_ignore_ids_from_words(word_str, vocab) -> tuple:
    """'|'-separated words -> sorted vocab-id tuple for the ngram-forbid
    ignore set; '[x]' forms are uppercased and unknown tokens map to [UNK]
    (reference: generation_decode.py:351-358)."""
    if not word_str:
        return ()
    w_list = [w.upper() if w.startswith("[") and w.endswith("]") else w
              for w in word_str.split("|")]
    return tuple(sorted({vocab.get(w, vocab.get("[UNK]", 0))
                         for w in w_list}))


class _Best:
    """Running best BLEU across runs (reference max_a..max_d,
    generation_decode.py:369-372)."""

    def __init__(self):
        self.a, self.b, self.c, self.d = [], [], [], []

    def update(self, bleu: dict) -> dict:
        self.a.append(bleu["Bleu_1"])
        self.b.append(bleu["Bleu_2"])
        self.c.append(bleu["Bleu_3"])
        self.d.append(bleu["Bleu_4"])
        return {"best_bleu1": max(self.a), "best_bleu2": max(self.b),
                "best_bleu3": max(self.c), "best_bleu4": max(self.d)}


def _resolve_positions(args, ckpt_kind, logger) -> str:
    """'auto' follows the checkpoint: a torch checkpoint was finetuned by
    the reference, whose decoder embeds every window at positions 0/1
    (model.py:1113-1121); the random init takes the train-consistent
    layout, as the JAX CLI gives it."""
    mode = args.decode_positions
    if mode != "auto":
        return mode
    mode = "reference" if ckpt_kind == "torch" else "train"
    if logger is not None:
        logger.info("decode_positions auto -> %s (checkpoint kind: %s)",
                    mode, ckpt_kind or "random-init")
    return mode


def model_config(args):
    """The FinetuneConfig the flags describe (the serve CLI's, plus
    ``--max_position_embeddings``)."""
    cfg = serve_main.model_config(args)
    if args.max_position_embeddings not in (0, None, 512):
        cfg = dataclasses.replace(cfg, bert=dataclasses.replace(
            cfg.bert, max_position_embeddings=args.max_position_embeddings))
    return cfg


def _recover(cfg, model_path: Optional[str], seed: int, device,
             logger) -> VLPForPreTraining:
    """The model with a torch checkpoint's weights, or with random weights
    from ``seed`` when ``model_path`` is None."""
    if model_path is not None:
        model = serve_main.recover_model(cfg, model_path, device, logger)
        logger.info("recovered torch model %s", model_path)
        return model
    model = VLPForPreTraining(cfg.bert, cfg.image,
                              len_vis_input=cfg.len_vis_input)
    init_weights(model, seed)
    return model.prepare_for_compute().eval().to(device)


def _decode_records(args, cfg, model, tokenizer, records, data_dir, logger,
                    ckpt_kind=None, device="cpu",
                    generator: Optional[torch.Generator] = None):
    """One decode pass over ``records``: returns (predictions, ppl or None,
    decoder seconds, batches)."""
    v = tokenizer.vocab
    forbid_ignore_ids = forbid_ignore_ids_from_words(args.forbid_ignore_word,
                                                     v)
    # the flag checks come first: a bad combination raises before any work
    sampling = sampling_kwargs(args, args.beam_size)
    settings = DecodeSettings(
        max_txt_length=args.max_txt_length, mask_word_id=v["[MASK]"],
        eos_id=v["[SEP]"], beam_size=args.beam_size,
        length_penalty=args.length_penalty,
        forbid_duplicate_ngrams=args.forbid_duplicate_ngrams,
        ngram_size=args.ngram_size, new_segment_ids=args.new_segment_ids,
        min_len=int(args.min_len or 0), forbid_ignore_ids=forbid_ignore_ids,
        window_positions=_resolve_positions(args, ckpt_kind, logger),
        **sampling)

    def image_loader(p):
        return image_lib.load_image(os.path.join(data_dir, p),
                                    args.img_size, grayscale_to_rgb=True,
                                    do_resize=(args.len_vis_input < 100))

    prep = Seq2seqDecodePreprocessor(cfg, tokenizer, args.max_txt_length)
    B = args.batch_size
    predictions = []
    total_nll, total_tok = 0.0, 0
    decode_s, batches = 0.0, 0
    for start in range(0, len(records), B):
        chunk = records[start:start + B]
        samples = [prep(r["img"], r["text"], image_loader) for r in chunk]
        # pad the short final batch with its last sample, as the JAX CLI
        # does for its static shapes (every record is scored; the padded
        # rows are dropped below)
        n_real = len(samples)
        samples += [samples[-1]] * (B - n_real)
        image = torch.from_numpy(np.stack([s["image"] for s in samples]))
        gt = np.stack([s["gt_token"] for s in samples])
        t0 = time.perf_counter()
        with torch.inference_mode():
            image = image.to(device)
            if args.beam_size > 1:
                out_ids, _ = beam_search(model, image, settings, v["[CLS]"],
                                         v["[SEP]"])
                gt_nll = None
            else:
                out_ids, _, gt_nll = greedy_decode(
                    model, image, settings, v["[CLS]"], v["[SEP]"],
                    gt_tokens=torch.from_numpy(gt).to(device),
                    teacher_forcing=args.teacher_forcing,
                    generator=generator)
                gt_nll = gt_nll.cpu().numpy()
            out_ids = out_ids.cpu().numpy()
        decode_s += time.perf_counter() - t0
        batches += 1
        if gt_nll is not None:
            mask = gt[:n_real] != 0
            total_nll += float((gt_nll[:n_real] * mask).sum())
            total_tok += int(mask.sum())
        for i, rec in enumerate(chunk):
            predictions.append({"image_id": rec.get("id", str(start + i)),
                                "caption": caption_from_ids(tokenizer,
                                                            out_ids[i]),
                                "gt_caption": rec["text"],
                                "gt_label": rec.get("label", "")})
    ppl = math.exp(total_nll / total_tok) if total_tok else None
    return predictions, ppl, decode_s, batches


def run_one(args, logger, metrics_path: str, best: _Best, device,
            generator: Optional[torch.Generator], dataset: str = "",
            model_name: str = "") -> List[dict]:
    """Decode one scenario: glob the recover path, bootstrap-loop, score.
    Returns one result dict per checkpoint x bootstrap round."""
    set_seed(args.seed)
    tokenizer = BertTokenizer.from_vocab_file(args.vocab_file)
    cfg = model_config(args)
    with open(args.src_file) as f:
        all_records = [json.loads(line) for line in f]
    data_dir = os.path.dirname(args.src_file)

    paths = sorted(glob_lib.glob(args.model_recover_path.strip())) \
        if args.model_recover_path else [None]
    if not paths:
        logger.warning("no checkpoints match %s; decoding random init",
                       args.model_recover_path)
        paths = [None]

    results = []
    for model_path in paths:
        model = _recover(cfg, model_path, args.seed, device, logger)
        ckpt_kind = None if model_path is None else "torch"
        for bootstrap in range(1, args.random_bootstrap_testnum + 1):
            if args.bootstrap_resample:
                # one random.choice per example, with replacement
                # (generation_decode.py:423)
                records = [random.choice(all_records)
                           for _ in range(len(all_records))]
            else:
                records = all_records
            predictions, ppl, decode_s, batches = _decode_records(
                args, cfg, model, tokenizer, records, data_dir, logger,
                ckpt_kind=ckpt_kind, device=device, generator=generator)
            if args.beam_size == 1 and ppl is not None:
                run_name = (f"{round(ppl, 2)}ppl_{dataset or 'cxr'}_"
                            f"{model_name or args.run_name}_{bootstrap}test")
            else:
                run_name = (f"{args.eval_model}{args.beam_size}beam"
                            f"{bootstrap}test")
            bleu = language_eval_bleu(predictions, args.output_dir, run_name)
            result = dict(bleu)
            if ppl is not None:
                result["ppl"] = ppl
            result.update(best.update(bleu))
            result.update({"run_name": run_name, "bootstrap": bootstrap,
                           "dataset": dataset, "model_name": model_name,
                           "decode_s": decode_s,
                           "decode_tokens_per_s": batches * args.batch_size
                           * args.max_txt_length / decode_s})
            logger.info("decode results: %s", result)
            with open(metrics_path, "a") as f:
                f.write(json.dumps({**result, "ts": time.time()}) + "\n")
            with open(os.path.join(args.output_dir,
                                   f"{run_name}_predictions.json"),
                      "w") as f:
                json.dump(predictions, f, indent=2)
            results.append(result)
        del model
    return results


def main(argv=None) -> List[dict]:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    os.makedirs(args.output_dir, exist_ok=True)
    logger = create_logger(os.path.join(args.output_dir, "decode.log"), args)
    metrics_path = os.path.join(args.output_dir, "metrics.jsonl")
    generator = torch.Generator(device=device).manual_seed(args.seed)
    best = _Best()
    all_results = []
    if args.scenarios:
        with open(args.scenarios) as f:
            table = json.load(f)
        for i, row in enumerate(table):
            sc_args = argparse.Namespace(**vars(args))
            dataset = row.pop("dataset", f"scenario{i + 1}")
            model_name = row.pop("model_name", "model")
            for k, val in row.items():
                if not hasattr(sc_args, k):
                    raise ValueError(f"unknown scenario key: {k}")
                setattr(sc_args, k, val)
            if not sc_args.src_file or not sc_args.model_recover_path:
                raise ValueError(
                    f"scenario {i + 1} needs src_file+model_recover_path")
            logger.info("=== scenario %d: %s/%s ===", i + 1, dataset,
                        model_name)
            all_results += run_one(sc_args, logger, metrics_path, best,
                                   device, generator, dataset=dataset,
                                   model_name=model_name)
    else:
        if not args.src_file or args.model_recover_path is None:
            raise SystemExit("--src_file and --model_recover_path required "
                             "(or use --scenarios)")
        all_results = run_one(args, logger, metrics_path, best, device,
                              generator, model_name=args.run_name)
    with open(os.path.join(args.output_dir, "all_results.json"), "w") as f:
        json.dump(all_results, f, indent=2)
    return all_results


if __name__ == "__main__":
    main()
