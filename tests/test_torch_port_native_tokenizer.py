"""The port's native wordpiece tokenizer (medvill_torch/data/
native_tokenizer.py over its own copy of wordpiece.cc): ids equal to the
port's Python tokenizer and to the JAX package's NativeBertTokenizer on
the cases and the fuzz of tests/test_native_tokenizer.py, the exact
fallbacks (non-ASCII text, a literal special-token bracket, a NUL byte,
more ids than the buffer holds), threads sharing one tokenizer, the
rebuild on source drift inside the port's build directory, builds by
several processes at once, and the four training CLIs building it through
``make_tokenizer``."""
import os
import random
import shutil
import subprocess
import sys
import threading

import pytest

from medvill_torch import cli as tcli
from medvill_torch.cli import (classification_main, finetune_main,
                               pretrain_main, retrieval_main)
from medvill_torch.data import native_tokenizer as nt
from medvill_torch.data.tokenization import BertTokenizer, load_vocab
from medvill_tpu.data.native_tokenizer import \
    NativeBertTokenizer as JaxNativeBertTokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = [
    "The right lung is clear.",
    "pleural effusions, left.",
    "unaffable word3 word29 nonsense-token",
    "  spaces\teverywhere\n and , punct..",
    "UPPER case LUNG",
    "",
    "a" * 150,  # a word over 100 characters -> [UNK]
]


@pytest.fixture(scope="module")
def vocab_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("vocab")
    words = (["[PAD]", "[unused1]", "[unused2]", "[UNK]", "[CLS]", "[SEP]",
              "[MASK]"]
             + [f"word{i}" for i in range(30)]
             + ["##s", "##ing", "lung", "pleura", "##l", "effusion", "the",
                "right", "left", "un", "##aff", "##able", ",", ".", "-"])
    f = d / "vocab.txt"
    f.write_text("\n".join(words) + "\n")
    return str(f)


@pytest.fixture(scope="module")
def native(vocab_file):
    t = nt.NativeBertTokenizer(vocab_file)
    assert t.native_available, "the port's wordpiece library did not build"
    return t


@pytest.fixture(scope="module")
def jax_native(vocab_file):
    return JaxNativeBertTokenizer(vocab_file)


def python_ids(vocab_file, text, remap_unused=True):
    return BertTokenizer(load_vocab(vocab_file, remap_unused)
                         ).tokenize_to_ids(text)


def test_library_builds_into_the_port_build_dir(native):
    build = os.path.join(REPO, "medvill_torch", "ops", "_build")
    assert os.path.dirname(nt._LIB_PATH) == build
    assert os.path.isfile(nt._LIB_PATH)
    assert nt._stamp() == nt._src_digest()
    assert not os.path.relpath(nt._SRC_PATH, REPO).startswith("native")


@pytest.mark.parametrize("text", CASES)
def test_native_matches_python_and_jax(native, jax_native, vocab_file, text):
    want = python_ids(vocab_file, text)
    assert native.tokenize_to_ids(text) == want
    assert jax_native.tokenize_to_ids(text) == want


def test_native_fuzz_matches_python_and_jax(native, jax_native, vocab_file):
    rng = random.Random(0)
    pieces = ["lung", "pleural", "effusion", "the", "right", "left",
              "word5", "xyzzy", ",", ".", "-", "  ", "\t", "CAPS"]
    python = BertTokenizer(load_vocab(vocab_file))
    for _ in range(200):
        text = "".join(rng.choice(pieces + [" "])
                       for _ in range(rng.randint(0, 30)))
        want = python.tokenize_to_ids(text)
        assert native.tokenize_to_ids(text) == want, repr(text)
        assert jax_native.tokenize_to_ids(text) == want, repr(text)


@pytest.mark.parametrize("text", ["café effusion", "report [SEP] more",
                                  "lung\x00effusion right"],
                         ids=["non-ascii", "bracket", "nul"])
def test_fallbacks_give_the_python_ids(native, vocab_file, text):
    """Non-ASCII text (accents stripped in Python), a literal special token
    (never split) and a NUL byte (C would stop at it; Python drops it) take
    the Python path."""
    assert native.tokenize_to_ids(text) == python_ids(vocab_file, text)


def test_overflow_falls_back_exactly(native, vocab_file):
    """More wordpieces than MAX_IDS: the library returns -1 and the exact
    Python path runs, so nothing is truncated."""
    text = "lung " * (native.MAX_IDS + 10)
    got = native.tokenize_to_ids(text)
    assert len(got) > native.MAX_IDS
    assert got == python_ids(vocab_file, text)


def test_vocab_remap_follows_the_flag(vocab_file):
    remapped = nt.NativeBertTokenizer(vocab_file)
    plain = nt.NativeBertTokenizer(vocab_file, remap_unused=False)
    assert "[X_SEP]" in remapped.vocab and "[SEP_0]" in remapped.vocab
    assert "[unused1]" in plain.vocab and "[X_SEP]" not in plain.vocab
    text = "the right lung"
    assert plain.tokenize_to_ids(text) == python_ids(vocab_file, text, False)


def test_threads_sharing_one_tokenizer_get_their_own_ids(native,
                                                         vocab_file):
    """The pretrain loader tokenizes on several threads and ctypes lets
    them into the library at once: 16 threads (more than the cores) with
    texts of different lengths, a short switch interval; every id list
    equals the Python one."""
    python = BertTokenizer(load_vocab(vocab_file))
    texts = [" ".join(["the right lung", "pleural effusion ,", "word7"][i % 3]
                      for _ in range(1 + 7 * i)) for i in range(16)]
    want = [python.tokenize_to_ids(t) for t in texts]
    bad = []

    def work(i):
        for _ in range(300):
            if native.tokenize_to_ids(texts[i]) != want[i]:
                bad.append(i)
                return

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert bad == []


def _private_copy(tmp_path, monkeypatch):
    src = tmp_path / "csrc" / "wordpiece.cc"
    src.parent.mkdir()
    shutil.copy(nt._SRC_PATH, src)
    build = tmp_path / "_build"
    monkeypatch.setattr(nt, "_SRC_PATH", str(src))
    monkeypatch.setattr(nt, "_BUILD_DIR", str(build))
    monkeypatch.setattr(nt, "_LIB_PATH", str(build / "libwordpiece.so"))
    monkeypatch.setattr(nt, "_STAMP_PATH",
                        str(build / "libwordpiece.so.src.sha256"))
    return src, build


def test_rebuild_on_source_drift(tmp_path, monkeypatch, vocab_file):
    """An unchanged source reuses the library; a drifted one is rebuilt
    and restamped (a stale binary must not win over edited source)."""
    src, build = _private_copy(tmp_path, monkeypatch)
    lib = nt.build_library()
    assert lib == str(build / "libwordpiece.so")
    mtime = os.path.getmtime(lib)
    assert nt.build_library() == lib
    assert os.path.getmtime(lib) == mtime
    with open(src, "a") as f:
        f.write("\n// drift marker\n")
    os.utime(lib, (mtime - 100, mtime - 100))
    assert nt.build_library() == lib
    assert os.path.getmtime(lib) > mtime - 100
    assert nt._stamp() == nt._src_digest()
    assert sorted(os.listdir(build)) == ["libwordpiece.so",
                                         "libwordpiece.so.src.sha256"]
    t = nt.NativeBertTokenizer(vocab_file, lib_path=lib)
    assert t.native_available
    assert t.tokenize_to_ids("the right lung") == python_ids(
        vocab_file, "the right lung")


def test_processes_building_at_once_all_load_it(tmp_path, monkeypatch,
                                                vocab_file):
    """Six processes force a build into one empty directory at once, as
    the test workers may at their first CLI run: each compiles to a name of
    its own and moves it into place, so every one loads a whole library
    and none leaves a temporary file."""
    src, build = _private_copy(tmp_path, monkeypatch)
    code = (
        "import sys\n"
        "from medvill_torch.data import native_tokenizer as nt\n"
        "src, build, vocab = sys.argv[1:4]\n"
        "nt._SRC_PATH = src\n"
        "nt._BUILD_DIR = build\n"
        "nt._LIB_PATH = build + '/libwordpiece.so'\n"
        "nt._STAMP_PATH = nt._LIB_PATH + '.src.sha256'\n"
        "lib = nt.build_library(force=True)\n"
        "t = nt.NativeBertTokenizer(vocab, lib_path=lib)\n"
        "assert t.native_available\n"
        "print(t.tokenize_to_ids('the right lung'))\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(src),
                               str(build), vocab_file], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(6)]
    outs = [p.communicate(timeout=120) for p in procs]
    want = str(python_ids(vocab_file, "the right lung"))
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == want
    assert sorted(os.listdir(build)) == ["libwordpiece.so",
                                         "libwordpiece.so.src.sha256"]


def test_make_tokenizer_falls_back_to_python_with_a_warning(
        monkeypatch, caplog, vocab_file):
    got = tcli.make_tokenizer(vocab_file, remap_unused=True)
    assert isinstance(got, nt.NativeBertTokenizer) and got.native_available
    monkeypatch.setattr(nt, "build_library", lambda force=False: None)
    with caplog.at_level("WARNING", logger="medvill_torch"):
        got = tcli.make_tokenizer(vocab_file, remap_unused=True)
    assert type(got) is BertTokenizer
    assert "native wordpiece library" in caplog.text
    assert got.tokenize_to_ids("the right lung") == python_ids(
        vocab_file, "the right lung")


class _Built(Exception):
    pass


@pytest.mark.parametrize("name, remap", [
    ("pretrain", False), ("finetune", True), ("classification", False),
    ("retrieval", False)])
def test_training_clis_build_the_native_tokenizer(monkeypatch, tmp_path,
                                                  vocab_file, name, remap):
    """Each training CLI builds its tokenizer through make_tokenizer with
    JAX's remap_unused (pretrain, classification and retrieval False,
    finetune True) and gets the native one: the run stops right there."""
    module, argv = {
        "pretrain": (pretrain_main, ["--train_dataset", "t.jsonl",
                                     "--output_path", str(tmp_path)]),
        "finetune": (finetune_main, ["--src_file", "t.jsonl",
                                     "--output_dir", str(tmp_path)]),
        "classification": (classification_main, [
            "--data_path", str(tmp_path), "--savedir", str(tmp_path)]),
        "retrieval": (retrieval_main, ["--output_path", str(tmp_path)]),
    }[name]
    built = []

    def make(vocab, remap_unused=False):
        built.append((tcli.make_tokenizer(vocab, remap_unused),
                      remap_unused))
        raise _Built

    monkeypatch.setattr(module, "make_tokenizer", make)
    with pytest.raises(_Built):
        module.main(argv + ["--vocab_file", vocab_file, "--device", "cpu"])
    (tok, got_remap), = built
    assert got_remap is remap
    assert isinstance(tok, nt.NativeBertTokenizer) and tok.native_available
