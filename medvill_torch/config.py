"""Typed configuration: a torch-free, jax-free copy of the JAX package's
``MaskVariant``, ``BertConfig``, ``ImageEncoderConfig``, ``PretrainConfig``,
``FinetuneConfig``, ``ClassificationConfig`` and ``DecodeConfig``
(medvill_tpu/core/config.py:16-329, 360-441), with the same fields and defaults so a ``config.json`` or a CLI
flag means the same thing to both packages.

``compute_dtype`` names the matmul/conv dtype; LayerNorm, BatchNorm and
softmax statistics are always f32.  ``remat``/``remat_mode`` (a memory
knob), ``fused_qkv`` (a JAX parameter-tree layout) and the TPU-only
``PretrainConfig`` fields (``mesh_shape``, ``donate_state``,
``mlm_loss_chunk``, ``ClassificationConfig.mesh_shape``) have no effect on
the port.  ``fast_dropout`` selects
the same Bernoulli(rate) marginal as plain dropout, so the port has one
dropout for both.  ``FinetuneConfig`` has every field of the JAX one but
``mesh_shape``.
"""
from __future__ import annotations

import dataclasses
import enum
import json
from typing import Optional, Tuple


class MaskVariant(enum.IntEnum):
    """The five self-attention mask variants (reference: README.md:25-33,
    data/dataset_origin.py:140-177).  Values are the wire format of the
    per-sample ``(variant, txt_len)`` spec; see ``data/masks.py``.

    - FULL: row r sees col c iff c is a valid (non-pad) position.
    - S2S: every row sees the image block (cols < num_img+2); text rows
      attend causally over the whole text block, padding included.
    - BAR: S2S plus image rows see everything.
    - NONCROSS: block-diagonal I<->I, T<->T with no padding mask.
    - ATTN1D: the 1-D padding mask broadcast over rows, densely FULL.
    - MIXED is not a wire value: the host resolves it per sample into FULL
      or S2S with probabilities (bi_prob, s2s_prob).
    """

    FULL = 0
    S2S = 1
    BAR = 2
    NONCROSS = 3
    ATTN1D = 4


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
    main_origin.py:133-139).  The port runs the ResNet-50 random-pixel and
    full-fiber encoders, and in the classification model also ``pool``
    (the 1-9-embed adaptive-pool table) and ``pool-half`` (the map pooled
    to half its side; ``pool_type`` avg or max); ``s2d_stem`` is a TPU
    layout choice with the same math as the plain 7x7/s2 stem the port
    always runs."""

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

    @property
    def num_fibers(self) -> int:
        """Spatial positions emitted by the CNN trunk: (img_size/32)^2."""
        return (self.img_size // 32) ** 2

    @staticmethod
    def test_tiny() -> "ImageEncoderConfig":
        return ImageEncoderConfig(img_size=64, num_image_embeds=3,
                                  img_hidden_size=64)


@dataclasses.dataclass(frozen=True)
class PretrainConfig:
    """Pretraining flags (reference: main_origin.py:66-152)."""

    train_dataset: str = ""
    test_dataset: Optional[str] = None
    output_path: str = "output"
    log_freq: int = 10

    mlm_task: bool = True
    itm_task: bool = True

    # mask variant flags (--attn_1d/--BAR_attn/--Mixed/--s2s_prob/--bi_prob/
    # --disturbing_mask; main_origin.py:90-95)
    attn_1d: bool = False
    bar_attn: bool = True
    mixed: bool = False
    s2s_prob: float = 1.0
    bi_prob: float = 0.0
    disturbing_mask: bool = False

    epochs: int = 50
    batch_size: int = 36
    num_workers: int = 4

    hidden_size: int = 768
    embedding_size: int = 768
    vocab_size: int = 30522
    bert_model: str = "bert-base-scratch"
    weight_load: bool = False
    pre_trained_model_path: Optional[str] = None

    img_position: bool = True
    seq_len: int = 253
    max_seq_len: int = 512

    bert: BertConfig = dataclasses.field(default_factory=BertConfig)
    image: ImageEncoderConfig = dataclasses.field(
        default_factory=ImageEncoderConfig)

    lr: float = 1e-5
    gradient_accumulation_steps: int = 4
    warmup: float = 0.1
    seed: int = 123
    dropout_prob: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-6
    weight_decay: float = 0.0

    mesh_shape: Tuple[int, ...] = (-1,)
    use_flash_attention: bool = True
    donate_state: bool = True
    mlm_loss_chunk: int = 128
    # gather only the labeled text positions before the vocab projection
    # (~38 of 253 at p=0.15; 96 is +10 sigma).  0 projects every text
    # position.
    mlm_gather_bound: int = 96

    def resolve_variant(self) -> "MaskVariant | None":
        """Map flags to a static variant; MIXED (per-sample) returns None."""
        if self.mixed:
            return None
        if self.bar_attn:
            return MaskVariant.BAR
        if self.disturbing_mask:
            return MaskVariant.NONCROSS
        if self.attn_1d:
            return MaskVariant.ATTN1D
        return MaskVariant.FULL

    @property
    def total_len(self) -> int:
        """[CLS] + img(N) + [SEP] + txt(seq_len) + [SEP]
        (reference: data/dataset_origin.py:37)."""
        return self.seq_len + self.image.num_image_embeds + 3


@dataclasses.dataclass(frozen=True)
class FinetuneConfig:
    """Report-generation / VQA finetune (reference: sc/finetune.py:50-186).
    ``drop_prob`` is the model dropout the CLI writes into both of
    ``bert``'s rates; ``max_drop_worst_ratio`` is the drop-worst ratio, on
    once the 1-based epoch exceeds ``drop_after``."""

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
    use_flash_attention: bool = True


@dataclasses.dataclass(frozen=True)
class ClassificationConfig:
    """MMBT multilabel classification (reference:
    Downstream_task/Classification/mmbt/main.py:23-91).  ``task_type``
    "multilabel" trains weighted BCE and reports AUROC/F1,
    "classification" softmax CE and accuracy; ``freeze_img``/``freeze_txt``
    are the epochs the image trunk / the text encoder stay frozen."""

    data_path: str = ""
    output_path: str = "output_clf"
    task: str = "mimic-cxr"  # mimic-cxr | openi
    task_type: str = "multilabel"
    batch_size: int = 56
    max_epochs: int = 10
    lr: float = 1e-4
    lr_factor: float = 0.5
    lr_patience: int = 2
    patience: int = 10       # early stop
    warmup: float = 0.1
    gradient_accumulation_steps: int = 1
    dropout_prob: float = 0.1
    max_seq_len: int = 512
    num_image_embeds: int = 256
    img_size: int = 512
    seed: int = 123
    freeze_img: int = 3
    freeze_txt: int = 5
    weight_classes: bool = True
    pretrained_ckpt: Optional[str] = None
    labels: Tuple[str, ...] = ()
    bert: BertConfig = dataclasses.field(default_factory=BertConfig)
    image: ImageEncoderConfig = dataclasses.field(
        default_factory=lambda: ImageEncoderConfig(num_image_embeds=256))
    mesh_shape: Tuple[int, ...] = (-1,)
    use_flash_attention: bool = True


@dataclasses.dataclass(frozen=True)
class DecodeConfig:
    """Generation decode (reference: sc/generation_decode.py:114-311)."""

    model_recover_path: str = ""
    src_file: str = ""
    output_dir: str = "output_decode"
    batch_size: int = 16
    beam_size: int = 1
    length_penalty: float = 0.0
    forbid_duplicate_ngrams: bool = False
    forbid_ignore_word: Optional[str] = None
    ngram_size: int = 3
    max_txt_length: int = 128   # reference --max_tgt_length
    len_vis_input: int = 256
    split: str = "test"
    seed: int = 123
    bert: BertConfig = dataclasses.field(default_factory=BertConfig)
    image: ImageEncoderConfig = dataclasses.field(
        default_factory=lambda: ImageEncoderConfig(num_image_embeds=256,
                                                   encoder="full-fiber"))
