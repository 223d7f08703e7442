"""Model FLOPs of the references at a cell's shapes, counted by torch's
FlopCounterMode on the meta device (2 a multiply-add; convolutions,
matmuls and attention products)."""

from __future__ import annotations

import functools

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import detector as R


@functools.lru_cache(maxsize=None)
def _detector_flops(items: tuple, k: int, prompts: int) -> int:
    m = dict(items)
    rc = R.DetCfg(depths=tuple(m["depths"]), dims=tuple(m["dims"]),
                  neck_scale=m["neck_scale"], neck_repeats=m["neck_repeats"],
                  embed_dims=m["embed_dims"], reg_max=m["reg_max"],
                  strides=tuple(m["strides"]), cls_hidden=m["cls_hidden"],
                  reg_hidden=m["reg_hidden"], num_prompts=prompts)
    h, w = m["img_size"]
    with torch.device("meta"):
        model = R.Detector(rc).eval()
        x = torch.zeros((1, h, w, 3), dtype=torch.uint8)
        emb = None if prompts else torch.zeros((k, rc.embed_dims))
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        model(x, emb)
    return fc.get_total_flops()


def detector_flops(model: dict, k: int, prompts: int = 0) -> int:
    """FLOPs of one image through the detector network and head."""
    items = tuple((key, tuple(v) if isinstance(v, list) else v)
                  for key, v in sorted(model.items()))
    return _detector_flops(items, k, prompts)


def ref_flops(vision: dict, text: dict, gh: int, gw: int, seq: int,
              n_obj: int) -> float:
    """Model FLOPs (2 a multiply-add) of one WeDetect-Ref chat: the ViT
    over gh x gw patches, the decoder over `seq` tokens (causal), and
    the grounding extras for n_obj proposals; RoIAlign's sampling and
    the norms are not counted."""
    s = gh * gw
    v = s // vision["merge"] ** 2
    hv, iv, m2 = vision["hidden"], vision["intermediate"], vision["merge"] ** 2
    patch_in = vision["in_ch"] * vision["temporal_patch"] * vision["patch"] ** 2
    vit = 2 * s * patch_in * hv + vision["depth"] * (
        2 * s * hv * 4 * hv + 4 * s * hv * iv + 4 * s * s * hv)
    mergers = (1 + len(vision["deepstack_idx"])) * (
        2 * v * (hv * m2) ** 2 + 2 * v * hv * m2 * vision["out_hidden"])
    d, hd = text["hidden"], text["head_dim"]
    q, kv = text["heads"] * hd, text["kv_heads"] * hd
    layer = (2 * seq * d * (2 * q + 2 * kv) + 6 * seq * d
             * text["intermediate"] + 4 * q * seq * (seq + 1) / 2)
    extras = (4 * v * d * d                         # image_pos_projector
              + 2 * v * d * 2 * d + 2 * 4 * v * (d // 2) * (d // 2)
              + 2 * v * d * 2 * d                   # the pyramid's convs
              + 2 * 49 * n_obj * (d // 4 + d // 2 + d) * d
              + 2 * n_obj * 49 * d * d + 2 * n_obj * d * d
              + 4 * n_obj * d * d)                  # object projectors
    return vit + mergers + text["layers"] * layer + extras
