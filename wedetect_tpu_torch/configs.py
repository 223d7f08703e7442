"""Model/run configuration for the WeDetect family.

The same frozen dataclasses and size table as `wedetect_tpu.configs`
(reference: config/wedetect_{tiny,base,large}.py); only `ModelCfg.dtype`
differs, giving a `torch.dtype`.

| size  | convnext depths  | convnext dims          | neck scale | repeats | head in_ch      | img  |
| tiny  | [3, 3, 9, 3]     | [96, 192, 384, 768]    | 0.75       | 6       | [96, 192, 384]  | 640  |
| base  | [3, 3, 27, 3]    | [128, 256, 512, 1024]  | 1.0        | 12      | [128, 256, 512] | 640  |
| large | [3, 3, 27, 3]    | [192, 384, 768, 1536]  | 1.5        | 12      | [192, 384, 768] | 1280 |
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class TestCfg:
    """Post-processing configuration (reference:
    config/wedetect_base.py:18-25, model_test_cfg)."""

    multi_label: bool = True
    nms_pre: int = 30000
    score_thr: float = 0.001
    nms_iou_thr: float = 0.7
    max_per_img: int = 300
    # test-time augmentation merge (reference test.py:96-102)
    tta_nms_iou_thr: float = 0.5
    tta_max_per_img: int = 100


@dataclasses.dataclass(frozen=True)
class TrainCfg:
    """Assigner + loss weights (reference: config/wedetect_base.py)."""

    tal_topk: int = 10
    tal_alpha: float = 0.5
    tal_beta: float = 6.0
    tal_eps: float = 1e-9
    loss_cls_weight: float = 0.5
    loss_bbox_weight: float = 7.5
    loss_dfl_weight: float = 1.5 / 4
    max_gt_per_image: int = 128


@dataclasses.dataclass(frozen=True)
class TextCfg:
    """XLM-RoBERTa text tower configuration (xlm-roberta-base config)."""

    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    vocab_size: int = 250002
    max_position_embeddings: int = 514
    pad_token_id: int = 1
    type_vocab_size: int = 1
    layer_norm_eps: float = 1e-5
    head_out: int = 768  # Linear(hidden -> head_out) then L2-normalize


TEXT_BASE = TextCfg()
TEXT_LARGE = TextCfg(hidden_size=1024, num_layers=24, num_heads=16,
                     intermediate_size=4096)


@dataclasses.dataclass(frozen=True)
class ModelCfg:
    """Full detector configuration."""

    name: str = "base"
    depths: Tuple[int, ...] = (3, 3, 27, 3)
    dims: Tuple[int, ...] = (128, 256, 512, 1024)
    neck_scale: float = 1.0
    neck_repeats: int = 12
    # optional 1x1 down-projection of the last backbone level (xlarge)
    backbone_down_proj: int = 0
    drop_path_rate: float = 0.0
    head_in_channels: Tuple[int, ...] = (128, 256, 512)
    embed_dims: int = 768
    reg_max: int = 16
    strides: Tuple[int, ...] = (8, 16, 32)
    cls_hidden: int = 256
    reg_hidden: int = 64
    use_bn_head: bool = True
    img_size: Tuple[int, int] = (640, 640)
    text: TextCfg | None = TEXT_BASE
    num_prompts: int = 0
    use_mlp_adapter: bool = False
    num_classes: int = 80
    # "bfloat16" runs convolutions and matmuls under bf16 autocast
    compute_dtype: str = "float32"
    # dynamic int8 block MLPs, neck convs and head tower convs
    # (ops/int8.py; inference only)
    quant_int8: bool = False
    test: TestCfg = TestCfg()
    train: TrainCfg = TrainCfg()

    @property
    def dtype(self) -> torch.dtype:
        return (torch.bfloat16 if self.compute_dtype == "bfloat16"
                else torch.float32)

    @property
    def num_anchors(self) -> int:
        h, w = self.img_size
        return sum((h // s) * (w // s) for s in self.strides)

    def feat_sizes(self, img_size: Tuple[int, int] | None = None):
        h, w = img_size or self.img_size
        return [(h // s, w // s) for s in self.strides]


def _sized(name: str, **kw) -> ModelCfg:
    table = {
        "tiny": dict(depths=(3, 3, 9, 3), dims=(96, 192, 384, 768),
                     neck_scale=0.75, neck_repeats=6,
                     head_in_channels=(96, 192, 384), img_size=(640, 640),
                     text=TEXT_BASE),
        "small": dict(depths=(3, 3, 27, 3), dims=(96, 192, 384, 768),
                      neck_scale=0.75, neck_repeats=12,
                      head_in_channels=(96, 192, 384), img_size=(640, 640),
                      text=TEXT_BASE),
        "base": dict(depths=(3, 3, 27, 3), dims=(128, 256, 512, 1024),
                     neck_scale=1.0, neck_repeats=12,
                     head_in_channels=(128, 256, 512), img_size=(640, 640),
                     text=TEXT_BASE),
        "large": dict(depths=(3, 3, 27, 3), dims=(192, 384, 768, 1536),
                      neck_scale=1.5, neck_repeats=12,
                      head_in_channels=(192, 384, 768), img_size=(1280, 1280),
                      text=TEXT_LARGE),
        "xlarge": dict(depths=(3, 3, 27, 3), dims=(256, 512, 1024, 2048),
                       neck_scale=1.0, neck_repeats=12,
                       head_in_channels=(128, 256, 512),
                       img_size=(1280, 1280), text=TEXT_LARGE,
                       backbone_down_proj=1024),
    }
    d = dict(table[name])
    d.update(kw)
    return ModelCfg(name=name, **d)


def wedetect_tiny(**kw) -> ModelCfg:
    return _sized("tiny", **kw)


def wedetect_base(**kw) -> ModelCfg:
    return _sized("base", **kw)


def wedetect_large(**kw) -> ModelCfg:
    return _sized("large", **kw)


def wedetect_uni(size: str = "base", num_prompts: int = 256, **kw) -> ModelCfg:
    """WeDetect-Uni: text tower replaced by a learned prompt bank
    (reference: generate_proposal.py:1052-1078)."""
    kw.setdefault("num_classes", num_prompts)
    return _sized(size, text=None, num_prompts=num_prompts, **kw)


def get_config(name: str, **kw) -> ModelCfg:
    if name.startswith("uni_"):
        return wedetect_uni(name[4:], **kw)
    return _sized(name, **kw)
