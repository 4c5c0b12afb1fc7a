"""medvill_torch modules against their JAX counterparts on the same numpy
inputs and the same weights (carried through vlp_state_dict_from_flax):
BERT layer and encoder with a K/V cache (fused LN off and on), the
ResNet-50 trunk from uint8 pixels, the MLM head with relax_projection, the
embeddings, and the sampling filter."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medvill_torch import config as tcfg
from medvill_torch.convert import _embeddings, _encoder, _trunk
from medvill_torch.models import bert as tbert
from medvill_torch.models import heads as theads
from medvill_torch.models import resnet as tresnet
from medvill_torch.models.decoder import filter_sample_logits as t_filter
from medvill_tpu.core.config import BertConfig
from medvill_tpu.models import bert as jbert
from medvill_tpu.models import heads as jheads
from medvill_tpu.models import resnet as jresnet
from medvill_tpu.models.decoder import filter_sample_logits as j_filter
from tests.torch_port_support import (perturb, random_batch_stats,
                                      sub_state_dict)

# f32 end to end on both sides; differences are summation order only
TOL = 1e-5


def _cfg(fused_ln=False):
    return dataclasses.replace(
        BertConfig.vlp(BertConfig.test_tiny(vocab_size=48)),
        fused_ln=fused_ln)


def _torch_cfg(cfg):
    return tcfg.BertConfig(**dataclasses.asdict(cfg))


def _encoder_weights(cfg, seed):
    enc = jbert.BertEncoder(cfg)
    x = jnp.zeros((1, 3, cfg.hidden_size))
    params = enc.init({"params": jax.random.PRNGKey(seed)}, x, None)["params"]
    params = perturb(params, np.random.default_rng(seed), 0.1)
    sd = {}
    _encoder(sd, "encoder", params)
    return params, sd


def _caches(cfg, B, L, rng):
    shape = (B, L, cfg.num_attention_heads, cfg.head_dim)
    return [(rng.standard_normal(shape).astype(np.float32),
             rng.standard_normal(shape).astype(np.float32))
            for _ in range(cfg.num_hidden_layers)]


def _bias(rows, L, visible_upto):
    c = np.arange(L)[None, None, None, :]
    r = np.asarray(visible_upto)[None, None, :, None]
    return np.where(c <= r, 0.0, -10000.0).astype(np.float32)


@pytest.mark.parametrize("fused_ln", [False, True], ids=["ln", "fused-ln"])
def test_bert_layer_with_cache(fused_ln):
    cfg = _cfg(fused_ln)
    params, sd = _encoder_weights(cfg, seed=1)
    rng = np.random.default_rng(2)
    B, W, L, idx = 2, 2, 9, 4
    hidden = rng.standard_normal((B, W, cfg.hidden_size)).astype(np.float32)
    (ck, cv), = _caches(dataclasses.replace(cfg, num_hidden_layers=1), B, L,
                        rng)
    bias = _bias(W, L, [idx, idx + 1])
    layer = jbert.BertLayer(cfg)
    want, (wk, wv) = layer.apply(
        {"params": params["layer_0"]}, jnp.asarray(hidden), jnp.asarray(bias),
        kv_cache=(jnp.asarray(ck), jnp.asarray(cv)), cache_index=idx)

    tl = tbert.BertLayer(_torch_cfg(cfg))
    tl.load_state_dict(sub_state_dict(sd, "encoder.layer.0."))
    cache = (torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy()))
    got, (gk, gv) = tl(torch.from_numpy(hidden), torch.from_numpy(bias),
                       kv_cache=cache, cache_index=idx)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(gk.detach().numpy(), np.asarray(wk),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(gv.detach().numpy(), np.asarray(wv),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("fused_ln", [False, True], ids=["ln", "fused-ln"])
def test_bert_encoder_prefill_then_window(fused_ln):
    """A 5-row prefill into empty caches at index 0, then a 2-row window
    at index 4 that overwrites slot 4 -- the decode pattern."""
    cfg = _cfg(fused_ln)
    params, sd = _encoder_weights(cfg, seed=3)
    rng = np.random.default_rng(4)
    B, L, H = 2, 9, cfg.hidden_size
    pre = rng.standard_normal((B, 5, H)).astype(np.float32)
    win = rng.standard_normal((B, 2, H)).astype(np.float32)
    pre_bias = _bias(5, L, [4] * 5)
    win_bias = _bias(2, L, [4, 5])

    enc = jbert.BertEncoder(cfg)
    v = {"params": params}
    zeros = [(jnp.zeros((B, L, cfg.num_attention_heads, cfg.head_dim)),) * 2
             for _ in range(cfg.num_hidden_layers)]
    _, jc = enc.apply(v, jnp.asarray(pre), jnp.asarray(pre_bias),
                      kv_caches=zeros, cache_index=0)
    want, jc = enc.apply(v, jnp.asarray(win), jnp.asarray(win_bias),
                         kv_caches=jc, cache_index=4)

    te = tbert.BertEncoder(_torch_cfg(cfg))
    te.load_state_dict(sub_state_dict(sd, "encoder."))
    tc = [(torch.zeros(B, L, cfg.num_attention_heads, cfg.head_dim),
           torch.zeros(B, L, cfg.num_attention_heads, cfg.head_dim))
          for _ in range(cfg.num_hidden_layers)]
    with torch.inference_mode():
        te(torch.from_numpy(pre), torch.from_numpy(pre_bias), kv_caches=tc,
           cache_index=0)
        got, tc = te(torch.from_numpy(win), torch.from_numpy(win_bias),
                     kv_caches=tc, cache_index=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    for (gk, gv), (wk, wv) in zip(tc, jc):
        np.testing.assert_allclose(gk.numpy(), np.asarray(wk), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=TOL,
                                   atol=TOL)


def test_embeddings_default_positions_and_types():
    cfg = _cfg()
    emb = jbert.BertEmbeddings(cfg)
    ids = np.random.default_rng(5).integers(0, 48, (2, 6)).astype(np.int32)
    params = perturb(emb.init({"params": jax.random.PRNGKey(5)},
                              jnp.asarray(ids))["params"],
                     np.random.default_rng(5), 0.1)
    want = emb.apply({"params": params}, jnp.asarray(ids))
    sd = {}
    _embeddings(sd, "e", params)
    te = tbert.BertEmbeddings(_torch_cfg(cfg))
    te.load_state_dict(sub_state_dict(sd, "e."))
    got = te(torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)


def test_pooler_matches_jax():
    cfg = _cfg()
    rng = np.random.default_rng(9)
    hidden = rng.standard_normal((3, 4, cfg.hidden_size)).astype(np.float32)
    pooler = jbert.BertPooler(cfg)
    params = perturb(pooler.init({"params": jax.random.PRNGKey(9)},
                                 jnp.asarray(hidden))["params"], rng, 0.1)
    want = pooler.apply({"params": params}, jnp.asarray(hidden))
    tp = tbert.BertPooler(_torch_cfg(cfg))
    tp.load_state_dict({"dense.weight": torch.from_numpy(
                            params["dense"]["kernel"].T.copy()),
                        "dense.bias": torch.from_numpy(
                            params["dense"]["bias"])})
    with torch.inference_mode():
        got = tp(torch.from_numpy(hidden))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_resnet_trunk_from_uint8_pixels():
    """JAX runs the space-to-depth stem, the port the plain 7x7/s2 conv on
    the same weights; BN uses non-trivial running statistics.  Tolerance
    1e-4 relative to the output scale: the convolutions sum in a different
    order through 53 layers."""
    img = np.random.default_rng(6).integers(0, 256, (2, 64, 64, 3),
                                            dtype=np.uint8)
    trunk = jresnet.ResNet50Trunk(dtype=jnp.float32, s2d_stem=True)
    v = jax.jit(trunk.init)({"params": jax.random.PRNGKey(6)},
                            jnp.asarray(img))
    rng = np.random.default_rng(6)
    params = perturb(v["params"], rng, 0.02)
    stats = random_batch_stats(v["batch_stats"], rng)
    want = jresnet.fibers(jax.jit(trunk.apply)(
        {"params": params, "batch_stats": stats}, jnp.asarray(img)))
    sd = {}
    _trunk(sd, "img_encoder", params, stats)
    tt = tresnet.ResNet50Trunk(dtype=torch.float32)
    tt.load_state_dict(sub_state_dict(sd, "img_encoder."))
    with torch.inference_mode():
        got = tresnet.fibers(tt(torch.from_numpy(img)))
    want = np.asarray(want)
    assert got.shape == want.shape == (2, 4, 2048)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-4 * scale)


def test_mlm_head_relax_projection():
    cfg = dataclasses.replace(_cfg(), relax_projection=4)
    rng = np.random.default_rng(7)
    B, L, H, V = 3, 2, cfg.hidden_size, cfg.vocab_size
    hidden = rng.standard_normal((B, L, H)).astype(np.float32)
    word = rng.standard_normal((V, H)).astype(np.float32)
    task = np.array([3, 0, 2], np.int32)
    head = jheads.MLMHead(cfg)
    params = head.init({"params": jax.random.PRNGKey(7)}, jnp.asarray(hidden),
                       jnp.asarray(word), task_idx=jnp.asarray(task))["params"]
    params = perturb(params, rng, 0.1)
    want = head.apply({"params": params}, jnp.asarray(hidden),
                      jnp.asarray(word), task_idx=jnp.asarray(task))

    emb = torch.nn.Embedding(V, H)
    emb.weight.data = torch.from_numpy(word)
    th = theads.MLMHead(_torch_cfg(cfg), emb)
    sd = {"transform.dense.weight": params["transform_dense"]["kernel"].T,
          "transform.dense.bias": params["transform_dense"]["bias"],
          "transform.LayerNorm.weight":
              params["transform_LayerNorm"]["scale"],
          "transform.LayerNorm.bias": params["transform_LayerNorm"]["bias"],
          "decoder.weight": word, "bias": params["decoder_bias"]}
    th.load_state_dict({k: torch.from_numpy(np.array(v))
                        for k, v in sd.items()})
    got = th(torch.from_numpy(hidden), torch.from_numpy(task))
    assert got.dtype == torch.float32 and got.shape == (B, L, V)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kw", [dict(), dict(temperature=0.7),
                                dict(top_k=5), dict(top_p=0.8),
                                dict(temperature=1.3, top_k=10, top_p=0.6)],
                         ids=["identity", "temperature", "top-k", "top-p",
                              "all"])
def test_filter_sample_logits_exact(kw):
    logits = np.random.default_rng(8).standard_normal((4, 50)).astype(
        np.float32) * 3
    want = np.asarray(j_filter(jnp.asarray(logits), **kw))
    got = t_filter(torch.from_numpy(logits), **kw).numpy()
    np.testing.assert_array_equal(got, want)
