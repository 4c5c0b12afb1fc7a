"""Learning-dynamics proof of the medvill_torch port: each of the four
workloads, driven through its real CLI entry point on a tiny structured
synthetic corpus, drives its training metric to the overfit target (the
port's counterpart of tools/overfit.py, with its corpus, workloads, epoch
budgets and targets):

  pretrain   MLM accuracy > 0.9 and ITM accuracy > 0.8, best 10-epoch mean
  classify   eval micro-F1 > 0.95 on an eval split equal to the train split
  retrieve   ITM pair accuracy > 0.9 (best 10-epoch mean), recovering the
             pretrain run
  finetune   the finetuned model decodes its own training reports: BLEU-1
             > 0.8 through the decode CLI, recovering the pretrain run
             (240 epochs under BertAdam's warmup-linear schedule)

Each workload prints one JSON line {"workload", "metric", "value",
"target", "ok", "seconds", "device"}; the exit status is 0 iff every
selected workload met its target.  On the card it first prints the card's
name and power limit (nvidia-smi).

Usage:
    python tools/torch_overfit.py [--device cuda|cpu]
        [--workloads pretrain,classify,retrieve,finetune] [--root DIR]
        [--n 16] [--epochs-scale 1.0] [--seed 123] [--pretrained RUN_DIR]

The finetune CLI writes a model/optim pair at every epoch (~95 MB each
here, 240 of them); this tool lets it write only the last epoch's.  It
imports nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

WORDS = ["no", "acute", "disease", "heart", "size", "normal", "lungs",
         "clear", "mild", "edema", "stable", "chest", "effusion", "right",
         "left", "small", "seen", "pleural", "focal", "consolidation"]
SPECIALS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
CHEXPERT = ["'Cardiomegaly'", "'Edema'", "'Pleural Effusion'", "'Others'"]
SMALL_BERT = "google/bert_uncased_L-2_H-128_A-2"


def make_structured_tree(root: str, n: int) -> None:
    """The learnable corpus of tools/overfit.py: 2 fixed sentences of
    disjoint vocabulary, one per class, and one noise image per class;
    record i carries sentence i % 2 and its class's image.  MLM reduces to
    (sentence, position) -> word, ITM, retrieval and report generation to
    image -> sentence class, and the classification label is a function
    of the text."""
    import numpy as np
    from PIL import Image

    os.makedirs(root, exist_ok=True)
    npr = np.random.default_rng(0)
    img_dir = os.path.join(root, "imgs")
    os.makedirs(img_dir, exist_ok=True)
    sentences = [" ".join([WORDS[k], WORDS[4 + k], WORDS[8 + k],
                           WORDS[12 + k], WORDS[16 + k], WORDS[k]])
                 for k in range(2)]
    class_imgs = [npr.integers(0, 255, (64, 64), np.uint8)
                  for _ in range(2)]
    rows = []
    for i in range(n):
        p = os.path.join(img_dir, f"{i}.png")
        Image.fromarray(class_imgs[i % 2], "L").save(p)
        rows.append({"i": i, "img": os.path.abspath(p),
                     "text": sentences[i % 2], "label": CHEXPERT[i % 2]})

    with open(os.path.join(root, "vocab.txt"), "w") as f:
        for w in SPECIALS + WORDS:
            f.write(w + "\n")

    def write(sub: str, names, record) -> None:
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        for fname in names:
            with open(os.path.join(root, sub, fname), "w") as f:
                for r in rows:
                    f.write(json.dumps(record(r)) + "\n")

    write("pretrain", ("Train.jsonl", "Valid.jsonl"), lambda r: {
        "id": f"p{r['i']}", "split": "train", "label": r["label"],
        "text": r["text"], "img": r["img"]})
    write("classification", ("Train.jsonl", "Valid.jsonl", "Test.jsonl"),
          lambda r: {"id": f"c{r['i']}", "text": r["text"],
                     "label": r["label"].strip("'"), "img": r["img"]})
    write("retrieval", ("train.jsonl",), lambda r: {
        "id": f"t{r['i']}", "split": "train", "label": r["label"],
        "text": r["text"], "img": r["img"]})
    write("reportgen", ("train.jsonl",), lambda r: {
        "id": f"r{r['i']}", "text": r["text"], "label": r["label"],
        "img": r["img"]})


def _rows(path: str) -> list:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f]


def _best_window(rows: list, key: str, w: int = 10):
    """Best w-epoch rolling mean of ``key``: did training reach the target
    (per-epoch accuracies on 16 records are 16-sample binomials)."""
    vals = [r[key] for r in rows if key in r]
    if not vals:
        return None
    if len(vals) < w:
        return sum(vals) / len(vals)
    return max(sum(vals[i:i + w]) / w for i in range(len(vals) - w + 1))


def _latest_model(run: str) -> str:
    from medvill_torch import checkpoint

    epoch = checkpoint.latest_epoch(run)
    if epoch is None:
        raise FileNotFoundError(f"{run}: no saved pretrain epoch")
    return os.path.join(run, f"model.{epoch}.bin")


def run_pretrain(root: str, out: str, epochs: int, device: str, seed: int,
                 pretrained=None) -> dict:
    from medvill_torch.cli import pretrain_main

    pretrain_main.main([
        "--train_dataset", os.path.join(root, "pretrain", "Train.jsonl"),
        "--vocab_file", os.path.join(root, "vocab.txt"),
        "--output_path", out, "--bert_model", SMALL_BERT,
        "--vocab_size", "32", "--epochs", str(epochs), "--batch_size", "8",
        "--num_image_embeds", "3", "--img_size", "64", "--seq_len", "8",
        "--gradient_accumulation_steps", "1", "--num_workers", "2",
        "--lr", "1e-3", "--save_interval", "50", "--watch_interval", "0",
        "--log_freq", "1000000", "--device", device, "--seed", str(seed)])
    rows = _rows(os.path.join(out, "metrics.jsonl"))
    mlm = _best_window(rows, "mlm_acc")
    itm = _best_window(rows, "itm_acc")
    return {"metric": "min(mlm_acc, itm_acc)",
            "value": min(v for v in (mlm, itm, 1.0) if v is not None),
            "target": "mlm>0.9, itm>0.8",
            "ok": bool(mlm and itm and mlm > 0.9 and itm > 0.8),
            "detail": {"mlm_acc": mlm, "itm_acc": itm}}


def run_classify(root: str, out: str, epochs: int, device: str, seed: int,
                 pretrained=None) -> dict:
    from medvill_torch.cli import classification_main

    data = os.path.join(out, "data")
    os.makedirs(data, exist_ok=True)
    src = os.path.join(root, "classification", "Train.jsonl")
    for name in ("Train.jsonl", "Valid.jsonl", "Test.jsonl"):
        shutil.copy(src, os.path.join(data, name))
    classification_main.main([
        "--data_path", data, "--vocab_file", os.path.join(root, "vocab.txt"),
        "--savedir", out, "--bert_model", "test-tiny",
        "--vocab_size", "32", "--batch_sz", "8",
        "--max_epochs", str(epochs), "--patience", str(epochs),
        "--num_image_embeds", "3", "--img_size", "64",
        "--max_seq_len", "16", "--name", "overfit", "--lr", "1e-3",
        "--device", device, "--seed", str(seed)])
    rows = _rows(os.path.join(out, "overfit", "metrics.jsonl"))
    f1 = max((r["micro_f1"] for r in rows if "micro_f1" in r),
             default=None)
    return {"metric": "eval micro_f1 (eval==train)", "value": f1,
            "target": 0.95, "ok": bool(f1 is not None and f1 > 0.95)}


def run_retrieve(root: str, out: str, epochs: int, device: str, seed: int,
                 pretrained=None) -> dict:
    from medvill_torch.cli import retrieval_main

    extra = ["--load_pretrained_model", pretrained] if pretrained else []
    retrieval_main.main([
        "--train_dataset", os.path.join(root, "retrieval", "train.jsonl"),
        "--vocab_file", os.path.join(root, "vocab.txt"),
        "--output_path", out, "--bert_model", SMALL_BERT,
        "--vocab_size", "32", "--batch_size", "8",
        "--epochs", str(epochs), "--seq_len", "8",
        "--num_image_embeds", "3", "--img_size", "64",
        "--do_train", "true", "--do_test", "false", "--lr", "1e-3",
        "--device", device, "--seed", str(seed)] + extra)
    acc = _best_window(_rows(os.path.join(out, "metrics.jsonl")),
                       "train_acc")
    return {"metric": "train ITM acc", "value": acc, "target": 0.9,
            "ok": bool(acc is not None and acc > 0.9)}


def run_finetune(root: str, out: str, epochs: int, device: str, seed: int,
                 pretrained=None) -> dict:
    from medvill_torch import checkpoint
    from medvill_torch.cli import decode_main, finetune_main

    train = os.path.join(root, "reportgen", "train.jsonl")
    vocab = os.path.join(root, "vocab.txt")
    ft_out = os.path.join(out, "ft")
    extra = (["--model_recover_path", _latest_model(pretrained)]
             if pretrained else [])
    save = checkpoint.save_training_state

    def save_last(directory, epoch, *args, **kwargs):
        if epoch == epochs - 1:
            return save(directory, epoch, *args, **kwargs)
        return ()

    checkpoint.save_training_state = save_last
    try:
        finetune_main.main([
            "--tasks", "report_generation", "--src_file", train,
            "--vocab_file", vocab, "--output_dir", ft_out,
            "--bert_model", SMALL_BERT, "--vocab_size", "32",
            "--train_batch_size", "8", "--num_train_epochs", str(epochs),
            "--len_vis_input", "3", "--img_size", "64",
            "--max_seq_length", "20", "--max_pred", "8", "--max_len_b",
            "14", "--learning_rate", "1e-3", "--device", device,
            "--seed", str(seed)] + extra)
    finally:
        checkpoint.save_training_state = save
    dec_out = os.path.join(out, "decode")
    decode_main.main([
        "--src_file", train, "--vocab_file", vocab,
        "--model_recover_path",
        os.path.join(ft_out, f"model.{epochs - 1}.bin"),
        "--output_dir", dec_out, "--bert_model", SMALL_BERT,
        "--vocab_size", "32", "--batch_size", "8", "--len_vis_input", "3",
        "--img_size", "64", "--max_seq_length", "20",
        "--max_tgt_length", "14", "--run_name", "overfit",
        "--device", device, "--seed", str(seed)])
    with open(os.path.join(dec_out, "all_results.json")) as f:
        results = json.load(f)
    b1 = max(r["Bleu_1"] for r in results)
    return {"metric": "train-set Bleu_1 after finetune", "value": b1,
            "target": 0.8, "ok": bool(b1 > 0.8)}


# (runner, epochs at the default 16 records): tools/overfit.py's budgets
WORKLOADS = {
    "pretrain": (run_pretrain, 400),
    "classify": (run_classify, 40),
    "retrieve": (run_retrieve, 40),
    "finetune": (run_finetune, 240),
}


def main() -> int:
    p = argparse.ArgumentParser(
        description="overfit proof over the port's four CLI workloads")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; the CLIs raise without a card) or "
                        "cpu")
    p.add_argument("--workloads", type=str,
                   default="pretrain,classify,retrieve,finetune")
    p.add_argument("--root", type=str,
                   default=os.path.join(tempfile.gettempdir(),
                                        "medvill_torch_overfit"),
                   help="work dir (synthetic data + run outputs), emptied "
                        "first")
    p.add_argument("--n", type=int, default=16,
                   help="synthetic records per split")
    p.add_argument("--epochs-scale", type=float, default=1.0,
                   help="multiply every workload's epoch budget")
    p.add_argument("--seed", type=int, default=123,
                   help="every CLI's --seed (123: their default, which "
                        "tools/overfit.py runs)")
    p.add_argument("--pretrained", type=str, default=None,
                   help="a pretrain run directory of this port for the "
                        "retrieve and finetune stages to recover from, "
                        "where 'pretrain' is not among --workloads")
    a = p.parse_args()
    kind = "cpu"
    if a.device == "cuda":
        import torch

        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True)
        print(smi.stdout.strip().splitlines()[0], flush=True)
        kind = torch.cuda.get_device_name(0)

    data_root = os.path.join(a.root, "data")
    shutil.rmtree(a.root, ignore_errors=True)
    make_structured_tree(data_root, n=a.n)
    pretrain_out = os.path.join(a.root, "pretrain")
    ok = True
    for name in a.workloads.split(","):
        name = name.strip()
        runner, epochs = WORKLOADS[name]
        pretrained = None
        if name in ("retrieve", "finetune"):
            from medvill_torch import checkpoint

            for src in (pretrain_out, a.pretrained):
                if src and checkpoint.latest_epoch(src) is not None:
                    pretrained = src
                    break
        t0 = time.time()
        res = runner(data_root, os.path.join(a.root, name),
                     max(1, int(round(epochs * a.epochs_scale))), a.device,
                     a.seed, pretrained)
        res = {"workload": name, **res, "seconds": time.time() - t0,
               "device": kind, "seed": a.seed}
        print(json.dumps(res), flush=True)
        ok = ok and res["ok"]
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
