"""Typed configuration for the serving slice: a torch-free, jax-free copy of
the JAX package's ``BertConfig``, ``ImageEncoderConfig`` and
``FinetuneConfig`` (medvill_tpu/core/config.py:46-212,360-418), with the
same fields and defaults so a ``config.json`` or a CLI flag means the same
thing to both packages.

``compute_dtype`` names the matmul/conv dtype; LayerNorm, BatchNorm and
softmax statistics are always f32.  The training fields (dropout rates,
``remat``, ``fast_dropout``, the optimiser settings of ``FinetuneConfig``)
and ``fused_qkv`` (a JAX parameter-tree layout) have no effect on the
port's inference path yet.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class BertConfig:
    """Mirror of HF/vendored BertConfig (reference:
    sc/pytorch_pretrained_bert/model.py:106-199)."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12
    compute_dtype: str = "bfloat16"
    remat: bool = False
    fused_qkv: bool = False
    fast_dropout: bool = False
    # run each encoder block's (dropout + residual-add + LayerNorm) through
    # the fused kernel (ops/fused_ln.py); parameter names are unchanged
    fused_ln: bool = False
    # >1: the MLM-head transform emits that many stacked task-specific
    # projections, selected per sample by task_idx (reference
    # sc/pytorch_pretrained_bert/model.py:435-496)
    relax_projection: int = 0
    remat_mode: str = "ffn"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @staticmethod
    def base() -> "BertConfig":
        return BertConfig()

    @staticmethod
    def small() -> "BertConfig":
        # google/bert_uncased_L-4_H-512_A-8
        return BertConfig(hidden_size=512, num_hidden_layers=4,
                          num_attention_heads=8, intermediate_size=2048)

    @staticmethod
    def tiny() -> "BertConfig":
        # google/bert_uncased_L-2_H-128_A-2
        return BertConfig(hidden_size=128, num_hidden_layers=2,
                          num_attention_heads=2, intermediate_size=512)

    @staticmethod
    def from_name(name: str, vocab_size: int = 30522) -> "BertConfig":
        """Map the reference's --bert_model names to configs
        (reference: main_origin.py:116-125 choices)."""
        if name in ("bert-small-scratch", "google/bert_uncased_L-4_H-512_A-8"):
            cfg = BertConfig.small()
        elif name == "google/bert_uncased_L-2_H-128_A-2":
            cfg = BertConfig.tiny()
        elif name == "test-tiny":
            return BertConfig.test_tiny(vocab_size=vocab_size)
        else:
            cfg = BertConfig.base()
        return dataclasses.replace(cfg, vocab_size=vocab_size)

    @staticmethod
    def vlp(base: "BertConfig | None" = None,
            new_segment_ids: bool = True) -> "BertConfig":
        """Config for the vendored finetune/decode stack: LayerNorm eps
        1e-5 (reference: sc/.../model.py:238) and type_vocab_size 6 when
        new_segment_ids (s2s uses segment ids 4/5)."""
        base = base or BertConfig.base()
        return dataclasses.replace(
            base, layer_norm_eps=1e-5,
            type_vocab_size=6 if new_segment_ids else 2)

    @staticmethod
    def from_reference_json(path: str,
                            base: "BertConfig | None" = None) -> "BertConfig":
        """Overlay a reference-style ``config.json`` onto ``base``; keys
        with no field here (task_idx, fp32_embedding, ...) are ignored."""
        with open(path) as f:
            d = json.load(f)
        base = base or BertConfig()
        fields = {f.name for f in dataclasses.fields(BertConfig)}
        return dataclasses.replace(
            base, **{k: v for k, v in d.items()
                     if k in fields and v is not None})

    @staticmethod
    def test_tiny(vocab_size: int = 128) -> "BertConfig":
        """Scratch config for unit tests."""
        return BertConfig(vocab_size=vocab_size, hidden_size=32,
                          num_hidden_layers=2, num_attention_heads=2,
                          intermediate_size=64, max_position_embeddings=512,
                          compute_dtype="float32")


@dataclasses.dataclass(frozen=True)
class ImageEncoderConfig:
    """Visual encoder config (reference: models/image.py,
    main_origin.py:133-139).  The port serves the full-fiber ResNet-50
    encoder only; ``s2d_stem`` is a TPU layout choice with the same math as
    the plain 7x7/s2 stem the port always runs."""

    encoder: str = "random-pixel"
    img_size: int = 512
    img_channel: int = 3
    img_hidden_size: int = 2048
    num_image_embeds: int = 180
    patch_size: int = 32
    pool_type: str = "avg"
    freeze_prefix_stages: bool = True
    remat_blocks: bool = False
    s2d_stem: bool = True


@dataclasses.dataclass(frozen=True)
class FinetuneConfig:
    """Report-generation / VQA finetune (reference: sc/finetune.py:50-186).
    The port reads only the decode geometry from it so far."""

    task: str = "report_generation"
    data_dir: str = ""
    src_file: str = ""
    output_dir: str = "output_finetune"
    model_recover_path: Optional[str] = None

    batch_size: int = 4
    epochs: int = 5
    lr: float = 3e-5
    warmup: float = 0.1
    weight_decay: float = 0.01
    gradient_accumulation_steps: int = 1
    label_smoothing: float = 0.1
    drop_prob: float = 0.1
    max_drop_worst_ratio: float = 0.0
    drop_after: int = 6
    trunc_seg: Optional[str] = "b"
    always_truncate_tail: bool = False
    sche_mode: str = "warmup_linear"
    max_pred: int = 3
    mask_prob: float = 0.15
    seed: int = 123

    len_vis_input: int = 256
    max_len_a: int = 256
    max_len_b: int = 253
    max_seq_length: int = 512
    new_segment_ids: bool = True

    s2s_prob: float = 1.0
    bi_prob: float = 0.0
    bar: bool = False
    mask_image_regions: bool = False
    vqa_organs: Tuple[str, ...] = ("chest",)
    vqa_num_answers: int = 458

    img_size: int = 512
    bert: BertConfig = dataclasses.field(default_factory=BertConfig)
    image: ImageEncoderConfig = dataclasses.field(
        default_factory=lambda: ImageEncoderConfig(num_image_embeds=256,
                                                   encoder="full-fiber"))
