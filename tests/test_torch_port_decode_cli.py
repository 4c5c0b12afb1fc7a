"""The port's decode CLI against the JAX package's on the CPU: both read the
same tiny torch ``model.0.bin`` and decode the same records (5 records at
batch 2, so a tail batch) at beam 1 and at beam 3 with n-gram forbidding:
equal predictions JSON, equal BLEU, ppl within 1e-5 relative, the same run
names and the same file set.  Also the scenarios table, the glob that
matches nothing, the refusals (a sampled beam, an orbax directory, an
unknown scenario key), the server's beam path, and the eval copies against
their JAX twins."""
import json
import logging
import os

import numpy as np
import pytest
import torch

from medvill_torch.cli import decode_main as tdecode
from medvill_torch.cli import serve_main
from medvill_torch.convert import save_state_dict, vlp_state_dict_from_flax
from medvill_torch.data.tokenization import BertTokenizer
from medvill_torch.eval import bleu as tbleu
from medvill_torch.eval import caption_metrics as tcap
from medvill_torch.eval import chexpert as tchex
from medvill_torch.eval import lang_utils as tlang
from medvill_torch.eval import meteor as tmeteor
from medvill_torch.models import decoder as tdec
from medvill_tpu.cli import decode_main as jdecode
from medvill_tpu.data.tokenization import build_vocab
from medvill_tpu.eval import bleu as jbleu
from medvill_tpu.eval import caption_metrics as jcap
from medvill_tpu.eval import chexpert as jchex
from medvill_tpu.eval import lang_utils as jlang
from medvill_tpu.eval import meteor as jmeteor
from tests.torch_port_support import (IMG, VIS, VOCAB, finetune_config,
                                      jax_vlp, torch_vlp)

N_REC, BATCH, T = 5, 2, 5
WORDS = [f"word{i}" for i in range(VOCAB - 5)]
# the run files every decode writes besides the per-run ones
COMMON_FILES = {"all_results.json", "metrics.jsonl", "decode.log"}


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("torch_decode_cli")
    vocab = build_vocab(WORDS)
    assert len(vocab) == VOCAB
    (d / "vocab.txt").write_text("".join(t + "\n" for t in vocab))
    rng = np.random.default_rng(0)
    with open(d / "Test.jsonl", "w") as f:
        for i in range(N_REC):
            name = f"img_{i}.png"
            Image.fromarray(rng.integers(0, 255, (IMG, IMG), np.uint8),
                            "L").save(d / name)
            f.write(json.dumps({"id": f"s{i}", "img": name,
                                "text": " ".join(rng.choice(WORDS, 6)),
                                "label": "'Others'"}) + "\n")
    cfg = finetune_config()
    _, variables = jax_vlp(cfg, seed=0)
    save_state_dict(vlp_state_dict_from_flax(variables["params"],
                                             variables["batch_stats"]),
                    str(d / "model.0.bin"))
    return d, variables


def _flags(d, out, *extra):
    return ["--vocab_file", str(d / "vocab.txt"),
            "--src_file", str(d / "Test.jsonl"),
            "--model_recover_path", str(d / "model.0.bin"),
            "--output_dir", str(out), "--batch_size", str(BATCH),
            "--max_tgt_length", str(T), "--len_vis_input", str(VIS),
            "--img_size", str(IMG), "--max_seq_length", "24",
            "--bert_model", "test-tiny", "--vocab_size", str(VOCAB), *extra]


def _port(d, out, *extra):
    return tdecode.main(_flags(d, out, "--device", "cpu", *extra))


def _jax(d, out, *extra):
    jdecode.main(jdecode.build_parser().parse_args(
        _flags(d, out, "--scan_layers", "true", *extra)))
    with open(os.path.join(out, "all_results.json")) as f:
        return json.load(f)


def _read(out, name):
    with open(os.path.join(out, name)) as f:
        return f.read()


BEAMS = {"greedy": (), "beam3-ngram": ("--beam_size", "3",
                                        "--forbid_duplicate_ngrams", "true",
                                        "--ngram_size", "2")}


@pytest.fixture(scope="module")
def jax_runs(fixture_dir, tmp_path_factory):
    d, _ = fixture_dir
    runs = {}
    for name, extra in BEAMS.items():
        out = tmp_path_factory.mktemp(f"jax_{name}")
        runs[name] = (str(out), _jax(d, out, *extra))
    return runs


@pytest.mark.parametrize("name", list(BEAMS))
def test_decode_cli_matches_jax(fixture_dir, jax_runs, tmp_path, name):
    d, _ = fixture_dir
    j_out, j_results = jax_runs[name]
    out = str(tmp_path / "port")
    results = _port(d, out, *BEAMS[name])
    assert len(results) == len(j_results) == 1
    r, jr = results[0], j_results[0]
    for k in ("Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "best_bleu1",
              "best_bleu4", "bootstrap", "dataset", "model_name"):
        assert r[k] == jr[k], k
    run, j_run = r["run_name"], jr["run_name"]
    if name == "greedy":
        np.testing.assert_allclose(r["ppl"], jr["ppl"], rtol=1e-5)
        # the name carries ppl to two decimals: at this fixture's ppl (~2e6,
        # random ground truth) the 1e-5 tolerance spans the last digits
        for res in (r, jr):
            assert res["run_name"] == \
                f"{round(res['ppl'], 2)}ppl_cxr_decode_1test"
    else:
        assert "ppl" not in r and run == j_run == "pretrained_3beam1test"
    assert r["decode_tokens_per_s"] > 0
    preds = json.loads(_read(out, f"{run}_predictions.json"))
    assert preds == json.loads(_read(j_out, f"{j_run}_predictions.json"))
    assert [p["image_id"] for p in preds] == [f"s{i}" for i in range(N_REC)]
    # the decode is not degenerate: the captions differ between images
    assert len({p["caption"] for p in preds}) > 1
    for suffix in (".csv", "_gt.csv"):
        assert _read(out, run + suffix) == _read(j_out, j_run + suffix)
    files = set(os.listdir(out))
    assert {f.replace(run, "RUN") for f in files} == \
        {f.replace(j_run, "RUN") for f in os.listdir(j_out)}
    assert files == COMMON_FILES | {f"{run}.csv", f"{run}_gt.csv",
                                    f"{run}_predictions.json"}


def test_decode_cli_scenarios_table(fixture_dir, jax_runs, tmp_path):
    """Two scenario rows (greedy, then beam 3 with n-gram forbidding), two
    bootstrap rounds each: one result per row x round, the running best,
    and each round's predictions equal to the single runs'."""
    d, _ = fixture_dir
    ckpt = str(d / "model.0.bin")
    rows = [{"dataset": "openi", "model_name": "s2s",
             "src_file": str(d / "Test.jsonl"), "model_recover_path": ckpt},
            {"dataset": "openi", "model_name": "vlp",
             "src_file": str(d / "Test.jsonl"),
             "model_recover_path": str(d / "model.*.bin"), "beam_size": 3,
             "forbid_duplicate_ngrams": True, "ngram_size": 2}]
    table = tmp_path / "scenarios.json"
    table.write_text(json.dumps(rows))
    out = str(tmp_path / "out")
    tdecode.main(["--vocab_file", str(d / "vocab.txt"), "--scenarios",
                  str(table), "--output_dir", out, "--batch_size",
                  str(BATCH), "--max_tgt_length", str(T), "--len_vis_input",
                  str(VIS), "--img_size", str(IMG), "--max_seq_length", "24",
                  "--bert_model", "test-tiny", "--vocab_size", str(VOCAB),
                  "--random_bootstrap_testnum", "2", "--device", "cpu"])
    with open(os.path.join(out, "all_results.json")) as f:
        results = json.load(f)
    assert [(r["model_name"], r["bootstrap"]) for r in results] == \
        [("s2s", 1), ("s2s", 2), ("vlp", 1), ("vlp", 2)]
    assert all("ppl_openi_s2s" in r["run_name"]
               for r in results[:2])
    assert [r["run_name"] for r in results[2:]] == \
        ["pretrained_3beam1test", "pretrained_3beam2test"]
    seen = -1.0
    for r in results:
        assert r["best_bleu1"] == max(seen, r["Bleu_1"])
        seen = r["best_bleu1"]
    for r, single in zip(results, ("greedy", "greedy", "beam3-ngram",
                                   "beam3-ngram")):
        j_out, (jr,) = jax_runs[single]
        assert _read(out, r["run_name"] + "_predictions.json") == \
            _read(j_out, jr["run_name"] + "_predictions.json")
    with open(os.path.join(out, "metrics.jsonl")) as f:
        assert len(f.readlines()) == 4
    rows[0]["beam"] = 2
    table.write_text(json.dumps(rows))
    with pytest.raises(ValueError, match="unknown scenario key: beam"):
        tdecode.main(["--vocab_file", str(d / "vocab.txt"), "--scenarios",
                      str(table), "--output_dir", out, "--device", "cpu"])


def test_decode_cli_refusals_and_random_init(fixture_dir, tmp_path, caplog):
    d, _ = fixture_dir
    args = tdecode.build_parser().parse_args(
        _flags(d, tmp_path, "--beam_size", "3", "--do_sample", "true"))
    assert args.device == "cuda"
    tok = BertTokenizer.from_vocab_file(str(d / "vocab.txt"))
    with pytest.raises(ValueError, match="do_sample"):
        tdecode._decode_records(args, None, None, tok, [], str(d), None)
    with pytest.raises(ValueError, match="medvill_tpu.cli.export_main"):
        _port(d, tmp_path / "dir", "--model_recover_path", str(tmp_path))
    # a pattern that matches nothing: a warning, then the random init
    out = str(tmp_path / "random")
    with caplog.at_level("WARNING", logger="medvill_torch"):
        results = _port(d, out, "--model_recover_path",
                        str(d / "nothing.*.bin"))
    assert "no checkpoints match" in caplog.text
    preds = json.loads(_read(out, results[0]["run_name"]
                             + "_predictions.json"))
    assert len(preds) == N_REC


def test_serve_engine_beam_path(fixture_dir):
    """build_engine with --beam_size 3 answers with beam_search's ids; a
    sampled beam is refused."""
    d, variables = fixture_dir
    flags = ["--vocab_file", str(d / "vocab.txt"), "--model_recover_path",
             str(d / "model.0.bin"), "--device", "cpu", "--batch_size",
             "2", "--max_txt_length", str(T), "--len_vis_input", str(VIS),
             "--img_size", str(IMG), "--bert_model", "test-tiny",
             "--vocab_size", str(VOCAB), "--beam_size", "3",
             "--forbid_duplicate_ngrams", "true", "--min_len", "1"]
    logger = logging.getLogger("test-torch-serve-beam")
    run, tok, _ = serve_main.build_engine(
        serve_main.build_parser().parse_args(flags), logger)
    images = np.random.default_rng(3).integers(0, 256, (2, IMG, IMG, 3),
                                               dtype=np.uint8)
    model = torch_vlp(finetune_config(), variables)
    v = tok.vocab
    settings = tdec.DecodeSettings(
        max_txt_length=T, mask_word_id=v["[MASK]"], eos_id=v["[SEP]"],
        beam_size=3, forbid_duplicate_ngrams=True, min_len=1)
    with torch.inference_mode():
        want, _ = tdec.beam_search(model, torch.from_numpy(images), settings,
                                   v["[CLS]"], v["[SEP]"])
    np.testing.assert_array_equal(run(images), want.numpy())
    with pytest.raises(ValueError, match="do_sample"):
        serve_main.build_engine(serve_main.build_parser().parse_args(
            flags + ["--do_sample", "true"]), logger)


def test_decode_preprocessor_and_config_match_jax(fixture_dir):
    """Seq2seqDecodePreprocessor's image and padded ground truth equal the
    JAX package's on the fixture's records of 6 words, cut at 4 tokens and
    zero-padded to 8; DecodeConfig's fields and defaults are JAX's."""
    import dataclasses

    from medvill_torch import config as tcfg
    from medvill_torch.data import images as timages
    from medvill_torch.data.seq2seq import Seq2seqDecodePreprocessor as TPrep
    from medvill_tpu.core import config as jcfg
    from medvill_tpu.data import images as jimages
    from medvill_tpu.data.seq2seq import Seq2seqDecodePreprocessor as JPrep
    from medvill_tpu.data.tokenization import BertTokenizer as JTokenizer

    d, _ = fixture_dir
    with open(d / "Test.jsonl") as f:
        records = [json.loads(line) for line in f]
    for n in (4, 8):
        t_prep = TPrep(None, BertTokenizer.from_vocab_file(
            str(d / "vocab.txt")), n)
        j_prep = JPrep(None, JTokenizer.from_vocab_file(
            str(d / "vocab.txt")), n)
        for r in records:
            got = t_prep(r["img"], r["text"], lambda p: timages.load_image(
                str(d / p), IMG, grayscale_to_rgb=True))
            want = j_prep(r["img"], r["text"], lambda p: jimages.load_image(
                str(d / p), IMG, grayscale_to_rgb=True))
            assert got.keys() == want.keys()
            for k in got:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k])
    t_fields = dataclasses.fields(tcfg.DecodeConfig)
    j_fields = dataclasses.fields(jcfg.DecodeConfig)
    assert [f.name for f in t_fields] == [f.name for f in j_fields]
    t_cfg, j_cfg = tcfg.DecodeConfig(), jcfg.DecodeConfig()
    for f in t_fields:
        t, j = getattr(t_cfg, f.name), getattr(j_cfg, f.name)
        assert (dataclasses.asdict(t) == dataclasses.asdict(j)
                if dataclasses.is_dataclass(t) else t == j), f.name


HYPS = ["no acute cardiopulmonary process .",
        "the heart is normal in size . lungs are clear",
        "mild cardiomegaly with small bilateral effusions",
        "there is no pneumothorax or pleural effusion ."]
REFS = ["no acute cardiopulmonary abnormality .",
        "heart size is normal . the lungs are clear",
        "cardiomegaly with bilateral pleural effusions and edema",
        "no pneumothorax . no pleural effusion ."]


def _preds():
    return [{"image_id": str(i), "caption": h, "gt_caption": r}
            for i, (h, r) in enumerate(zip(HYPS, REFS))]


def _labels(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    lab = rng.choice([1.0, 0.0, -1.0, np.nan], (6, 14))
    lab[0] = np.nan  # an all-blank row
    return lab


@pytest.mark.parametrize("metric", ["bleu", "rouge_cider", "meteor",
                                    "chexpert", "language_eval"])
def test_eval_copies_match_jax(metric, tmp_path):
    hyps = [h.split() for h in HYPS]
    refs = [[r.split()] for r in REFS]
    if metric == "bleu":
        assert tbleu.corpus_bleu(refs, hyps) == jbleu.corpus_bleu(refs, hyps)
        t_out, j_out = str(tmp_path / "t"), str(tmp_path / "j")
        assert tbleu.language_eval_bleu(_preds(), t_out, "run") == \
            jbleu.language_eval_bleu(_preds(), j_out, "run")
        for name in ("run.csv", "run_gt.csv"):
            assert _read(t_out, name) == _read(j_out, name)
    elif metric == "rouge_cider":
        assert tcap.rouge_l(hyps, refs) == jcap.rouge_l(hyps, refs)
        assert tcap.cider_d(hyps, refs) == jcap.cider_d(hyps, refs)
    elif metric == "meteor":
        ref_strs = [[r] for r in REFS]
        assert tmeteor.meteor_strings(HYPS, ref_strs) == \
            jmeteor.meteor_strings(HYPS, ref_strs)
        assert tmeteor.meteor_divergence_bound(HYPS, ref_strs) == \
            jmeteor.meteor_divergence_bound(HYPS, ref_strs)
        words = [w for h in HYPS + REFS for w in h.split()]
        assert [tmeteor.porter_stem(w) for w in words] == \
            [jmeteor.porter_stem(w) for w in words]
    elif metric == "chexpert":
        hyp, ref = _labels(1), _labels(2)
        t_v2, j_v2 = tchex.label_accuracy_v2(hyp, ref), \
            jchex.label_accuracy_v2(hyp, ref)
        assert t_v2[0] == j_v2[0]
        np.testing.assert_array_equal(t_v2[1], j_v2[1])
        assert tchex.label_accuracy_v3(hyp, ref) == \
            jchex.label_accuracy_v3(hyp, ref)
        assert tchex.label_accuracy_v4(hyp, ref) == \
            jchex.label_accuracy_v4(hyp, ref)
        paths = []
        for name, lab in (("hyp.csv", hyp), ("ref.csv", ref)):
            path = tmp_path / name
            lines = ["Reports," + ",".join(tchex.CHEXPERT_COLUMNS)] + [
                "r," + ",".join("" if np.isnan(x) else str(x) for x in row)
                for row in lab]
            path.write_text("\n".join(lines) + "\n")
            paths.append(str(path))
        t_all = tchex.evaluate_reports(*paths)
        assert t_all == jchex.evaluate_reports(*paths)
        assert t_all["acc_v2"] == t_v2[0]
    else:
        assert tlang.language_eval(_preds()) == jlang.language_eval(_preds())
