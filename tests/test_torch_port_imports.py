"""The port stands alone: importing every medvill_torch module,
chip_smoke, tools/torch_overfit and tools/torch_overfit_itm loads neither
jax nor medvill_tpu, and the entry points that run on the card refuse a
host without one instead of falling back to the CPU."""
import os
import pkgutil
import shutil
import subprocess
import sys

import pytest
import torch

import medvill_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        medvill_torch.__path__, "medvill_torch."))


def test_modules_import_neither_jax_nor_medvill_tpu():
    names = _modules()
    for name in ("cli.serve_main", "cli.pretrain_main", "ops.fused_ln",
                 "ops.flash_attention", "ops.dropout", "data.masks",
                 "data.pretrain", "data.sampling", "models.joint",
                 "models.cxrbert", "train.optim", "train.pretrain",
                 "cli.finetune_main", "checkpoint", "data.seq2seq",
                 "data.vqa", "train.finetune", "train.losses",
                 "cli.decode_main", "eval.bleu", "eval.caption_metrics",
                 "eval.meteor", "eval.chexpert", "eval.lang_utils",
                 "cli.classification_main", "data.classification",
                 "eval.metrics", "models.mmbt", "train.classify",
                 "utils.seed", "torch_init", "utils.preempt",
                 "data.retrieval", "models.cnn_bert", "train.retrieve",
                 "cli.retrieval_main", "data.native_tokenizer", "parallel",
                 "utils.tracing"):
        assert f"medvill_torch.{name}" in names
    code = (
        "import importlib, sys\n"
        f"for name in {names!r} + ['chip_smoke', 'tools.torch_overfit',\n"
        "                         'tools.torch_overfit_itm']:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax',\n"
        "                                    'medvill_tpu'))\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without a CUDA device")


def test_cuda_entry_points_raise_without_a_card():
    _no_cuda()
    from medvill_torch.cli import serve_main
    from medvill_torch.utils.device import resolve_device

    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    args = serve_main.build_parser().parse_args(
        ["--vocab_file", "v.txt", "--model_recover_path", "m.bin"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_main.build_engine(args, None)
    from medvill_torch.cli import pretrain_main

    with pytest.raises(RuntimeError, match="no CUDA device"):
        pretrain_main.main(["--train_dataset", "t.jsonl", "--vocab_file",
                            "v.txt"])
    from medvill_torch.cli import finetune_main

    with pytest.raises(RuntimeError, match="no CUDA device"):
        finetune_main.main(["--src_file", "t.jsonl", "--vocab_file",
                            "v.txt"])
    from medvill_torch.cli import decode_main

    with pytest.raises(RuntimeError, match="no CUDA device"):
        decode_main.main(["--src_file", "t.jsonl", "--vocab_file", "v.txt",
                          "--model_recover_path", "m.bin"])
    from medvill_torch.cli import classification_main

    with pytest.raises(RuntimeError, match="no CUDA device"):
        classification_main.main(["--data_path", "d", "--vocab_file",
                                  "v.txt"])
    from medvill_torch.cli import retrieval_main

    with pytest.raises(RuntimeError, match="no CUDA device"):
        retrieval_main.main(["--vocab_file", "v.txt"])


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path, where):
    """No result line on a CPU-only host, nor from a directory holding
    chip_smoke.py and nothing else of the repo."""
    _no_cuda()
    cwd = REPO
    if where == "alone":
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
