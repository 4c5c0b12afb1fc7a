"""The port's HTTP server on the CPU: a tiny checkpoint written by
vlp_state_dict_from_flax, three concurrent requests at batch 2 (one full
and one padded batch), each caption equal to the JAX greedy decode of the
same image; /healthz, /metrics, and the refusal of an orbax directory."""
import base64
import io
import json
import logging
import threading
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest

from medvill_torch.cli import serve_main
from medvill_torch.convert import save_state_dict, vlp_state_dict_from_flax
from medvill_tpu.data.images import load_image
from medvill_tpu.data.tokenization import (BertTokenizer, build_vocab,
                                           caption_from_ids)
from medvill_tpu.models.decoder import DecodeSettings, greedy_decode
from tests.torch_port_support import IMG, VIS, finetune_config, jax_vlp

T = 4


def _args(d, ckpt, *extra):
    return serve_main.build_parser().parse_args([
        "--vocab_file", str(d / "vocab.txt"), "--model_recover_path", ckpt,
        "--device", "cpu", "--host", "127.0.0.1", "--port", "0",
        "--batch_size", "2", "--max_wait_ms", "200",
        "--max_txt_length", str(T), "--len_vis_input", str(VIS),
        "--img_size", str(IMG), "--bert_model", "test-tiny",
        "--vocab_size", "64", *extra])


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_serve")
    vocab = build_vocab([f"word{i}" for i in range(59)])
    assert len(vocab) == 64
    (d / "vocab.txt").write_text("".join(t + "\n" for t in vocab))
    cfg = finetune_config(fused_ln=True)
    model, variables = jax_vlp(cfg, seed=0)
    ckpt = str(d / "model.1.bin")
    save_state_dict(vlp_state_dict_from_flax(variables["params"],
                                             variables["batch_stats"]), ckpt)
    (d / "cfg.json").write_text(json.dumps({"fused_ln": True}))
    server = serve_main.make_server(
        _args(d, ckpt, "--config_path", str(d / "cfg.json")),
        logging.getLogger("test-torch-serve"))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield d, server, model, variables, BertTokenizer(vocab)
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)


def _png(seed: int) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.random.default_rng(seed).integers(
        0, 255, (IMG, IMG), np.uint8), "L").save(buf, format="PNG")
    return buf.getvalue()


def _url(server, path):
    host, port = server.server_address[:2]
    return f"http://{host}:{port}{path}"


def _post(server, payload, path="/generate"):
    req = urllib.request.Request(
        _url(server, path), data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


def test_concurrent_captions_equal_jax_greedy(served):
    d, server, model, variables, tok = served
    pngs = [_png(i) for i in range(3)]
    results = {}

    def call(i):
        results[i] = _post(server, {"image_b64":
                                    base64.b64encode(pngs[i]).decode()})

    threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    images = np.stack([load_image(io.BytesIO(p), IMG, grayscale_to_rgb=True,
                                  do_resize=True) for p in pngs])
    v = tok.vocab
    settings = DecodeSettings(max_txt_length=T, mask_word_id=v["[MASK]"],
                              eos_id=v["[SEP]"], window_positions="reference")
    ids, _, _ = greedy_decode(model, variables, jnp.asarray(images), settings,
                              v["[CLS]"], v["[SEP]"])
    for i in range(3):
        status, body = results[i]
        assert status == 200, body
        assert body["caption"] == caption_from_ids(tok, np.asarray(ids)[i])
    assert any(results[i][1]["caption"] for i in range(3)), results
    stats = server.batcher.stats
    assert stats["batches_total"] >= 2 and stats["padded_rows_total"] >= 1


def test_healthz_and_metrics(served):
    _, server, *_ = served
    with urllib.request.urlopen(_url(server, "/healthz"), timeout=30) as r:
        body = json.loads(r.read())
    assert r.status == 200 and body["status"] == "ok"
    assert body["batch_size"] == 2 and body["device"] == "cpu"
    _post(server, {"image_b64": base64.b64encode(_png(7)).decode()})
    with urllib.request.urlopen(_url(server, "/metrics"), timeout=30) as r:
        text = r.read().decode()
    metrics = dict(line.rsplit(" ", 1) for line in text.splitlines()
                   if line and not line.startswith("#"))
    assert float(metrics["medvill_serve_compiled_batch_size"]) == 2
    assert float(metrics["medvill_serve_requests_total"]) >= 1
    assert float(metrics["medvill_serve_decode_seconds_total"]) > 0


def test_bad_request_and_bad_reload(served):
    import urllib.error

    d, server, *_ = served
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, {"nope": 1})
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, {"model_recover_path": str(d / "missing.bin")},
              path="/reload")
    assert e.value.code == 404
    status, body = _post(server, {"model_recover_path":
                                  str(d / "model.1.bin")}, path="/reload")
    assert status == 200 and body["status"] == "reloaded"


def test_orbax_directory_is_refused(served):
    d, *_ = served
    with pytest.raises(ValueError, match="medvill_tpu.cli.export_main"):
        serve_main.build_engine(_args(d, str(d)), logging.getLogger("t"))


def test_top1_sampling_engine_equals_greedy(served):
    """--do_sample with top_k 1 draws the argmax: the sampling engine (its
    seeded generator on the serve device) returns the greedy ids."""
    d, *_ = served
    ckpt = str(d / "model.1.bin")
    images = np.random.default_rng(5).integers(0, 256, (2, IMG, IMG, 3),
                                               dtype=np.uint8)
    logger = logging.getLogger("t")
    greedy, _, _ = serve_main.build_engine(_args(d, ckpt), logger)
    sample, _, _ = serve_main.build_engine(
        _args(d, ckpt, "--do_sample", "true", "--top_k", "1"), logger)
    np.testing.assert_array_equal(sample(images), greedy(images))


@pytest.mark.parametrize("extra, match", [
    (("--beam_size", "2"), "beam search"),
    (("--top_k", "5"), "require --do_sample"),
    (("--do_sample", "true", "--top_p", "0"), "top_p"),
], ids=["beam", "knob-without-sampling", "bad-top-p"])
def test_unsupported_or_bad_decode_flags_are_refused(served, extra, match):
    d, *_ = served
    args = _args(d, str(d / "model.1.bin"), *extra)
    with pytest.raises(ValueError, match=match):
        serve_main.build_engine(args, logging.getLogger("t"))
