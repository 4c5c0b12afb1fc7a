"""Shared fixtures for the medvill_torch parity tests: a tiny JAX VLP
model with perturbed weights (so greedy decode does not collapse onto one
token), carried into the port through ``vlp_state_dict_from_flax``."""
from __future__ import annotations

import dataclasses
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medvill_torch import config as tcfg
from medvill_torch.convert import vlp_state_dict_from_flax
from medvill_torch.models.seq2seq import VLPForPreTraining as TorchVLP
from medvill_tpu.core.config import (BertConfig, FinetuneConfig,
                                     ImageEncoderConfig)
from medvill_tpu.train import finetune as ft

IMG = 64
VIS = 4
VOCAB = 64


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one intra-op thread for a module's tests: the tiny shapes
    here take the same time on one thread, and the default (one thread
    per core) makes every worker of a parallel test run contend with the
    others for the CPU. Import it into a test module to apply it there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def perturb(tree, rng: np.random.Generator, scale: float):
    """Add N(0, scale) noise to every leaf (numpy out)."""
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + rng.normal(0.0, scale, np.shape(a)).astype(np.float32), tree)


def random_batch_stats(tree, rng: np.random.Generator):
    """Non-trivial BatchNorm running statistics: mean ~ N(0, 0.1), var in
    [0.5, 1.5]."""
    def f(path, a):
        name = str(path[-1].key)
        if name == "mean":
            return rng.normal(0.0, 0.1, np.shape(a)).astype(np.float32)
        return rng.uniform(0.5, 1.5, np.shape(a)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(f, tree)


def finetune_config(fused_ln: bool = False, vocab: int = VOCAB,
                    relax_projection: int = 0) -> FinetuneConfig:
    bert = dataclasses.replace(
        BertConfig.vlp(BertConfig.test_tiny(vocab_size=vocab)),
        fused_ln=fused_ln, relax_projection=relax_projection)
    return FinetuneConfig(
        bert=bert, image=ImageEncoderConfig(img_size=IMG, num_image_embeds=VIS,
                                            encoder="full-fiber"),
        len_vis_input=VIS, max_seq_length=24, max_pred=3, img_size=IMG)


def jax_vlp(cfg: FinetuneConfig, seed: int = 0):
    """(model, variables) with perturbed params and BN stats."""
    model = ft.build_model(cfg)
    L = cfg.max_seq_length
    # one jitted init compiles in seconds; eager init dispatches (and
    # compiles) every op of the ResNet on its own
    variables = jax.jit(lambda key: model.init(
        {"params": key},
        jnp.zeros((2, IMG, IMG, 3)), jnp.zeros((2, L), jnp.int32),
        jnp.zeros((2, L), jnp.int32), jnp.zeros((2, 1, L, L)),
        masked_pos=jnp.zeros((2, cfg.max_pred), jnp.int32),
        deterministic=True))(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    # large enough that the output depends on the image and the prefix;
    # the 53-conv trunk gets less, or its activations overflow f32
    init = variables["params"]
    params = perturb(init, rng, 0.3)
    params["bert"]["encoder"] = perturb(init["bert"]["encoder"], rng, 0.5)
    params["bert"]["img_encoder"] = perturb(init["bert"]["img_encoder"],
                                            rng, 0.02)
    # unit-scale word embeddings make the tied vocabulary projection, not
    # the decoder bias, decide the argmax
    word = params["bert"]["embeddings"]["word_embeddings"]
    word["embedding"] = rng.standard_normal(
        word["embedding"].shape).astype(np.float32)
    stats = random_batch_stats(variables["batch_stats"], rng)
    return model, {"params": params, "batch_stats": stats}


def port_config(cfg: FinetuneConfig):
    """The port's (BertConfig, ImageEncoderConfig) for a JAX config."""
    bert = tcfg.BertConfig(**dataclasses.asdict(cfg.bert))
    image = tcfg.ImageEncoderConfig(**dataclasses.asdict(cfg.image))
    return bert, image


def torch_vlp(cfg: FinetuneConfig, variables) -> TorchVLP:
    bert, image = port_config(cfg)
    model = TorchVLP(bert, image, len_vis_input=cfg.len_vis_input)
    sd = vlp_state_dict_from_flax(variables["params"],
                                  variables["batch_stats"])
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in sd.items()})
    return model.eval()


def sub_state_dict(sd: dict, prefix: str) -> dict:
    """Keys under ``prefix`` with it stripped, as torch tensors."""
    return {k[len(prefix):]: torch.from_numpy(np.array(v))
            for k, v in sd.items() if k.startswith(prefix)}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch_ranks(inputs: str, out: str, part: str):
    """Two ranks of tests/torch_parallel_worker.py (gloo on the CPU, one
    torch thread each) on ``part`` of its scenarios, started: a launcher's
    variables in their environment, a free port on localhost."""
    env = dict(os.environ, WORLD_SIZE="2", MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()), OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "torch_parallel_worker.py")
    return [subprocess.Popen(
        [sys.executable, worker, inputs, out, part], cwd=out,
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]


def wait_ranks(procs, out: str) -> list:
    """Both ranks' results (``launch_ranks``), [rank 0's, rank 1's]; a rank
    that failed fails the caller with the end of its log."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-6000:]}"
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(2)]
