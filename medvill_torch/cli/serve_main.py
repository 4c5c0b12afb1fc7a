"""Report-generation serving endpoint on PyTorch (the counterpart of
medvill_tpu/cli/serve_main.py).

One model on one device; requests are micro-batched by a single dispatcher
thread up to a fixed batch (short batches pad by repeating the last image,
the padded rows are discarded), and the HTTP layer stays on host threads so
image decode overlaps device work.  The dispatcher thread runs the decode
under ``torch.inference_mode()``.

API:
  GET  /healthz            -> {"status": "ok", model/config info}
  GET  /metrics            -> Prometheus text counters
  POST /generate           -> {"caption": ...}    (single image)
       body JSON: {"image_b64": <base64 bytes of any PIL-decodable image>}
                  or {"image_path": <server-local path>}
  POST /reload             -> swap the served weights
       body JSON: {"model_recover_path": <torch .bin>} (omit to re-read the
       current path)

Checkpoints are torch ``model.{epoch}.bin`` files in the reference layout.
An orbax directory written by the JAX package is refused; convert it with
``python -m medvill_tpu.cli.export_main`` first.  Greedy and sampled decode
are served, and beam search with ``--beam_size`` above 1.

Usage (on the card; ``--device cpu`` runs it on the CPU):
  python -m medvill_torch.cli.serve_main --vocab_file vocab.txt \
      --model_recover_path model.30.bin --config_path cfg.json
"""
from __future__ import annotations

import argparse
import base64
import dataclasses
import io
import json
import queue
import signal
import threading
import time

import numpy as np
import torch

from medvill_torch.cli import sampling_kwargs, str2bool, window_positions
from medvill_torch.config import BertConfig, FinetuneConfig, ImageEncoderConfig
from medvill_torch.convert import load_vlp_checkpoint
from medvill_torch.data import images as image_lib
from medvill_torch.data.tokenization import BertTokenizer, caption_from_ids
from medvill_torch.models.decoder import (DecodeSettings, beam_search,
                                          greedy_decode)
from medvill_torch.models.seq2seq import VLPForPreTraining
from medvill_torch.utils.device import resolve_device
from medvill_torch.utils.logging import create_logger
from medvill_torch.utils.seed import set_seed


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--vocab_file", type=str, required=True)
    p.add_argument("--model_recover_path", type=str, required=True,
                   help="torch model.{epoch}.bin")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to serve on (cuda | cuda:N | cpu)")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8390)
    p.add_argument("--batch_size", type=int, default=8,
                   help="decode batch; requests are micro-batched up to "
                        "this size")
    p.add_argument("--max_wait_ms", type=int, default=25,
                   help="micro-batching window: how long the dispatcher "
                        "waits to fill a batch after the first request")
    p.add_argument("--beam_size", type=int, default=1)
    p.add_argument("--do_sample", type=str2bool, default=False,
                   help="multinomial sampling instead of argmax (requires "
                        "--beam_size 1); one seeded generator advances "
                        "across micro-batches")
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top_k", type=int, default=0)
    p.add_argument("--top_p", type=float, default=1.0)
    p.add_argument("--length_penalty", type=float, default=0.0)
    p.add_argument("--forbid_duplicate_ngrams", type=str2bool, default=False)
    p.add_argument("--ngram_size", type=int, default=3)
    p.add_argument("--min_len", type=int, default=0)
    p.add_argument("--max_txt_length", type=int, default=128)
    p.add_argument("--len_vis_input", type=int, default=256)
    p.add_argument("--img_size", type=int, default=512)
    p.add_argument("--max_seq_length", type=int, default=None)
    p.add_argument("--new_segment_ids", type=str2bool, default=True)
    p.add_argument("--bert_model", type=str, default="bert-base-scratch")
    p.add_argument("--vocab_size", type=int, default=30522)
    p.add_argument("--config_path", type=str, default=None,
                   help="JSON overlaid on the BertConfig, e.g. "
                        '{"fused_ln": true}')
    p.add_argument("--relax_projection", action="store_true")
    p.add_argument("--decode_positions", type=str, default="auto",
                   choices=["auto", "reference", "train", "global"],
                   help="auto: reference for a checkpoint the reference "
                        "trained (its decoder embeds each window at "
                        "positions 0/1), train for one this port trained "
                        "(an optim.<N>.bin of its training state beside "
                        "it)")
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--warmup", type=str2bool, default=True,
                   help="run one dummy batch before accepting requests")
    return p


def model_config(args) -> FinetuneConfig:
    """The FinetuneConfig the serve flags describe (fills in
    ``args.max_seq_length`` when it was left unset)."""
    bert = BertConfig.vlp(
        BertConfig.from_name(args.bert_model, args.vocab_size),
        new_segment_ids=args.new_segment_ids)
    if args.relax_projection:
        bert = dataclasses.replace(bert, relax_projection=4)
    if args.config_path:
        bert = BertConfig.from_reference_json(args.config_path, base=bert)
    if args.max_seq_length is None:
        args.max_seq_length = args.max_txt_length + args.len_vis_input + 3
    return FinetuneConfig(
        max_seq_length=args.max_seq_length,
        len_vis_input=args.len_vis_input, img_size=args.img_size,
        new_segment_ids=args.new_segment_ids, bert=bert,
        image=ImageEncoderConfig(num_image_embeds=args.len_vis_input,
                                 img_size=args.img_size,
                                 encoder="full-fiber"))


def recover_model(cfg: FinetuneConfig, path: str, device,
                  logger) -> VLPForPreTraining:
    """The VLP model of ``cfg`` with a torch checkpoint's weights, in eval
    mode on ``device``, its matmul weights in the compute dtype."""
    model = VLPForPreTraining(cfg.bert, cfg.image,
                              len_vis_input=cfg.len_vis_input)
    extra = load_vlp_checkpoint(model, path)
    if extra:
        logger.info("checkpoint keys not used by the model: %d (e.g. %s)",
                    len(extra), extra[:3])
    return model.prepare_for_compute().eval().to(device)


def build_engine(args, logger):
    """Model + recovered weights + the batch decode function.  Returns
    (run(images uint8 [B,H,W,3]) -> ids [B,T], tokenizer,
    reload_weights(path) -> kind)."""
    device = resolve_device(args.device)
    set_seed(args.seed)
    tokenizer = BertTokenizer.from_vocab_file(args.vocab_file)
    cfg = model_config(args)

    def recover(path: str) -> VLPForPreTraining:
        return recover_model(cfg, path, device, logger)

    live = {"model": recover(args.model_recover_path)}
    logger.info("recovered torch checkpoint %s on %s",
                args.model_recover_path, device)

    positions = window_positions(args.decode_positions,
                                 args.model_recover_path, logger)
    v = tokenizer.vocab
    settings = DecodeSettings(
        max_txt_length=args.max_txt_length, mask_word_id=v["[MASK]"],
        eos_id=v["[SEP]"], beam_size=args.beam_size,
        length_penalty=args.length_penalty,
        forbid_duplicate_ngrams=args.forbid_duplicate_ngrams,
        ngram_size=args.ngram_size, min_len=args.min_len,
        new_segment_ids=args.new_segment_ids, window_positions=positions,
        **sampling_kwargs(args, args.beam_size))
    generator = None
    if settings.sample_mode == "sample":
        generator = torch.Generator(device=device).manual_seed(args.seed)

    def run(images: np.ndarray) -> np.ndarray:
        # inference_mode is thread-local: entered here, on the dispatcher
        # thread that launches the device work
        with torch.inference_mode():
            image = torch.from_numpy(np.ascontiguousarray(images)).to(device)
            if settings.beam_size > 1:
                ids, _ = beam_search(live["model"], image, settings,
                                     v["[CLS]"], v["[SEP]"])
            else:
                ids, _, _ = greedy_decode(live["model"], image, settings,
                                          v["[CLS]"], v["[SEP]"],
                                          generator=generator)
            return ids.cpu().numpy()

    def reload_weights(path: str) -> str:
        """Swap the served weights.  The new model is built and loaded
        first; the dict-slot assignment is atomic under the GIL and the
        dispatcher reads it once per micro-batch, so every batch runs one
        consistent model."""
        live["model"] = recover(path)
        logger.info("reloaded torch checkpoint %s", path)
        return "torch"

    return run, tokenizer, reload_weights


class ServerClosing(Exception):
    """Raised by submit() after close(): request arrived during drain."""


class MicroBatcher:
    """Single dispatcher thread: collects requests for up to max_wait_ms
    (or until the batch fills), pads short batches by repeating the last
    image, runs the decode, fans results back out."""

    def __init__(self, run, batch_size: int, max_wait_ms: int):
        self._run = run
        self._B = batch_size
        self._wait_s = max_wait_ms / 1000.0
        self._q: "queue.Queue" = queue.Queue()
        # counters exposed at GET /metrics; updated under the lock from
        # handler threads and the dispatcher thread
        self.stats = {"requests_total": 0, "errors_total": 0,
                      "batches_total": 0, "padded_rows_total": 0,
                      "decode_seconds_total": 0.0,
                      "request_latency_seconds_total": 0.0}
        self._stats_lock = threading.Lock()
        self._closing = False
        self._busy = False
        # HTTP handler threads between accept and response; drain() waits
        # for them too
        self._http_inflight = 0
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def enter_http(self) -> None:
        with self._stats_lock:
            self._http_inflight += 1

    def exit_http(self) -> None:
        with self._stats_lock:
            self._http_inflight -= 1

    def close(self) -> None:
        """Stop accepting new requests (graceful shutdown, SIGTERM)."""
        self._closing = True

    def drain(self, timeout: float = 30.0) -> bool:
        """Wait until every accepted request has been answered.  Call
        close() first; returns False on timeout."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._stats_lock:
                http_idle = self._http_inflight == 0
            if self._q.empty() and not self._busy and http_idle:
                return True
            time.sleep(0.05)
        return False

    def submit(self, image: np.ndarray):
        """Blocks until the token ids for `image` [H, W, 3] are ready."""
        if self._closing:
            raise ServerClosing("server is shutting down")
        t0 = time.monotonic()
        done = threading.Event()
        slot = {"done": done}
        self._q.put((image, slot))
        done.wait()
        with self._stats_lock:
            self.stats["requests_total"] += 1
            self.stats["request_latency_seconds_total"] += (
                time.monotonic() - t0)
            if "error" in slot:
                self.stats["errors_total"] += 1
        if "error" in slot:
            raise RuntimeError(slot["error"])
        return slot["ids"]

    def _loop(self):
        while True:
            items = [self._q.get()]
            self._busy = True
            deadline = time.monotonic() + self._wait_s
            while len(items) < self._B:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    items.append(self._q.get(timeout=remaining))
                except queue.Empty:
                    break
            images = [it[0] for it in items]
            n_real = len(images)
            if n_real < self._B:
                images = images + [images[-1]] * (self._B - n_real)
            t0 = time.monotonic()
            try:
                ids = self._run(np.stack(images))
            except Exception as e:  # fan the failure out to every waiter
                for _, slot in items:
                    slot["error"] = repr(e)
                    slot["done"].set()
                self._busy = False
                continue
            finally:
                with self._stats_lock:
                    self.stats["batches_total"] += 1
                    self.stats["padded_rows_total"] += self._B - n_real
                    self.stats["decode_seconds_total"] += (
                        time.monotonic() - t0)
            for i, (_, slot) in enumerate(items):
                slot["ids"] = ids[i]
                slot["done"].set()
            self._busy = False


def make_handler(batcher: MicroBatcher, tokenizer, args, logger,
                 reload_weights=None):
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *a):  # route to our logger, not stderr
            logger.info("%s " + fmt, self.address_string(), *a)

        def do_GET(self):
            batcher.enter_http()
            try:
                self._do_get()
            finally:
                batcher.exit_http()

        def do_POST(self):
            batcher.enter_http()
            try:
                self._do_post()
            finally:
                batcher.exit_http()

        def _do_get(self):
            if self.path == "/healthz":
                self._reply(200, {
                    "status": "ok",
                    "model_recover_path": args.model_recover_path,
                    "device": args.device,
                    "batch_size": args.batch_size,
                    "beam_size": args.beam_size,
                    "max_txt_length": args.max_txt_length})
            elif self.path == "/metrics":
                with batcher._stats_lock:
                    stats = dict(batcher.stats)
                lines = ["# TYPE medvill_serve_compiled_batch_size gauge",
                         f"medvill_serve_compiled_batch_size {batcher._B}"]
                for k, v in sorted(stats.items()):
                    lines.append(f"# TYPE medvill_serve_{k} counter")
                    lines.append(f"medvill_serve_{k} {v}")
                body = ("\n".join(lines) + "\n").encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._reply(404, {"error": "unknown path"})

        MAX_BODY = 64 << 20  # one 512x512 PNG is ~0.5 MB

        def _body(self):
            length = int(self.headers.get("Content-Length", 0))
            if length > self.MAX_BODY:
                raise ValueError(f"body {length} bytes > {self.MAX_BODY}")
            return self.rfile.read(length) or b"{}"

        def _do_post(self):
            if self.path == "/reload":
                try:
                    req = json.loads(self._body())
                    path = req.get("model_recover_path",
                                   args.model_recover_path)
                    kind = reload_weights(path)
                except FileNotFoundError as e:
                    self._reply(404, {"error": str(e)})
                    return
                except Exception as e:
                    self._reply(400, {"error": f"bad request: {e!r}"})
                    return
                args.model_recover_path = path  # /healthz reflects it
                self._reply(200, {"status": "reloaded", "kind": kind,
                                  "model_recover_path": path})
                return
            if self.path != "/generate":
                self._reply(404, {"error": "unknown path"})
                return
            try:
                req = json.loads(self._body())
                if "image_b64" in req:
                    raw = io.BytesIO(base64.b64decode(req["image_b64"]))
                    image = _load(raw, args)
                elif "image_path" in req:
                    image = _load(req["image_path"], args)
                else:
                    self._reply(400, {"error":
                                      "need image_b64 or image_path"})
                    return
            except Exception as e:
                self._reply(400, {"error": f"bad request: {e!r}"})
                return
            try:
                ids = batcher.submit(image)
            except ServerClosing as e:
                self._reply(503, {"error": str(e)})
                return
            except RuntimeError as e:
                self._reply(500, {"error": str(e)})
                return
            self._reply(200,
                        {"caption": caption_from_ids(tokenizer, ids)})

    return Handler


def _load(path_or_file, args) -> np.ndarray:
    """Same transform stack as decode eval (grayscale->RGB, resize below
    100 fibers as the JAX server does)."""
    return image_lib.load_image(
        path_or_file, args.img_size, grayscale_to_rgb=True,
        do_resize=(args.len_vis_input < 100))


def make_server(args, logger):
    """Build engine + micro-batcher + HTTP server (not yet serving)."""
    from http.server import ThreadingHTTPServer

    run, tokenizer, reload_weights = build_engine(args, logger)
    warmup_seconds = None
    if args.warmup:
        t0 = time.perf_counter()
        rng = np.random.default_rng(0)
        # uint8: the wire format _load produces
        dummy = rng.integers(0, 255, (args.batch_size, args.img_size,
                                      args.img_size, 3)).astype(np.uint8)
        run(dummy)
        warmup_seconds = time.perf_counter() - t0
        logger.info("warmup run: %.1fs", warmup_seconds)
    batcher = MicroBatcher(run, args.batch_size, args.max_wait_ms)
    server = ThreadingHTTPServer(
        (args.host, args.port),
        make_handler(batcher, tokenizer, args, logger, reload_weights))
    server.batcher = batcher  # for graceful drain (main) and tests
    server.warmup_seconds = warmup_seconds
    return server


def install_graceful_shutdown(server, logger,
                              signals=(signal.SIGTERM,)) -> None:
    """SIGTERM: stop accepting (new submits get 503), let the serve loop
    exit, then main() drains already-accepted requests before exiting."""

    def handler(signum, frame):
        logger.info("signal %d: draining in-flight requests, then "
                    "shutting down", signum)
        server.batcher.close()
        # shutdown() joins the serve loop, which the handler runs inside
        threading.Thread(target=server.shutdown, daemon=True).start()

    for s in signals:
        signal.signal(s, handler)


def main(args):
    logger = create_logger(None, args)
    server = make_server(args, logger)
    install_graceful_shutdown(server, logger)
    logger.info("serving on http://%s:%d (batch %d, wait %dms, %s)",
                *server.server_address, args.batch_size, args.max_wait_ms,
                args.device)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
    if server.batcher.drain(timeout=30.0):
        logger.info("drained; exiting 0")
    else:
        logger.warning("drain timed out with requests still queued")
    server.server_close()


if __name__ == "__main__":
    main(build_parser().parse_args())
