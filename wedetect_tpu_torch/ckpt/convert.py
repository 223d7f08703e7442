"""Checkpoints for the port.

The port's modules carry the reference checkpoint's canonical torch key
names, so loading a reference `.pth` is a key remap
(`canonicalize_torch_keys`, copied from `wedetect_tpu.ckpt.convert`)
and `load_state_dict(strict=True)`.

`from_jax_variables` goes the other way from the JAX package: flax
`variables` (as numpy) -> a port state dict, the exact inverse of
`wedetect_tpu.ckpt.convert.convert_detector`; `from_jax_text_params`
inverts `wedetect_tpu.nn.xlmr.convert_hf_text_tower`;
`from_jax_module` carries one legacy module across (RepVGGBlock, the
YOLO-World / YOLOv5 / YOLOv8 necks and bricks, the YOLOv5 head: the
inverses of `convert_yolo_world_pafpn`, `convert_yolov5_pafpn`, ...),
and `from_jax_clip_text` / `from_jax_clip_vision` the CLIP towers (the
inverses of `wedetect_tpu.nn.clip.convert_clip_text` / `_vision`).
Layouts:
    conv HWIO -> OIHW (depthwise (kh, kw, 1, C) -> (C, 1, kh, kw))
    linear (in, out) -> (out, in)
    conv-transpose (in, out, 2, 2) unchanged
    BN scale/bias + batch_stats mean/var -> weight/bias/running_*
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from wedetect_tpu_torch.configs import ModelCfg, TextCfg

StateDict = Dict[str, torch.Tensor]


def canonicalize_torch_keys(sd: Mapping) -> Dict:
    """mmdet-format keys -> standalone-format keys.

    Mirrors the remap in generate_proposal.py:1236-1254:
      backbone.image_model.model.X -> backbone.X
      bbox_head.head_module.X -> bbox_head.X  with ConvModule names
      flattened: {lvl}.0.conv->.0, .0.bn->.1, .1.conv->.3, .1.bn->.4,
      .{lvl}.2.->.{lvl}.6.
    Text-tower keys (backbone.text_model.*) and already-canonical keys
    pass through unchanged; BN `num_batches_tracked` counters are
    dropped. Values are passed through as they are.
    """
    out: Dict = {}
    for key, val in sd.items():
        if "num_batches_tracked" in key:
            continue
        k = key
        if k.startswith("backbone.image_model.model."):
            k = "backbone." + k[len("backbone.image_model.model."):]
        if k.startswith("bbox_head.head_module."):
            k = "bbox_head." + k[len("bbox_head.head_module."):]
            for lvl in ("0.", "1.", "2."):
                k = k.replace(f"preds.{lvl}2.", f"preds.{lvl}6.")
            k = k.replace("1.bn.", "4.")
            k = k.replace("1.conv.", "3.")
            k = k.replace("0.bn.", "1.")
            k = k.replace("0.conv.", "0.")
        out[k] = val
    return out


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Load a .pth file into a flat {key: CPU tensor} dict (handles a
    'state_dict' wrapper). This unpickles the file: load only trusted
    checkpoints."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    return {k: torch.as_tensor(v) for k, v in ckpt.items()}


def load_into(model: nn.Module, sd: Mapping) -> nn.Module:
    """Load the entries of `sd` that `model` has, strictly.

    Every parameter and running statistic of `model` must be in `sd`
    (KeyError naming the missing ones otherwise); extra entries (other
    towers, optimizer state) are ignored. BN `num_batches_tracked`
    counters, which checkpoints may omit, keep the model's own value.
    A scalar stored as shape (1,) loads into a () parameter.
    """
    want = model.state_dict()
    missing = [k for k in want
               if k not in sd and not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} keys, e.g. "
                       f"{missing[:5]}")
    full = {}
    for k, ref in want.items():
        v = torch.as_tensor(sd[k]) if k in sd else ref
        if ref.dim() == 0 and v.numel() == 1:
            v = v.reshape(())
        full[k] = v
    model.load_state_dict(full, strict=True)
    return model


# ------------------------------------------------------------ JAX -> port
def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _conv(k) -> torch.Tensor:
    return _t(np.transpose(np.asarray(k), (3, 2, 0, 1)))


def _lin(k) -> torch.Tensor:
    return _t(np.transpose(np.asarray(k)))


class _Writer:
    """Accumulates port keys from flax subtrees. The leaf methods (`t`,
    `conv_w`, `lin_w`, `conv1x1_w`, `scalar`) turn a flax leaf into the port's
    tensor; `_PathWriter` overrides them to record the leaf's path."""

    def __init__(self):
        self.sd: StateDict = {}

    def t(self, x):
        return _t(x)

    def conv_w(self, x):
        return _conv(x)

    def lin_w(self, x):
        return _lin(x)

    def conv1x1_w(self, x):
        """A Dense kernel (in, out) as a 1x1 conv's (out, in, 1, 1)."""
        return _lin(x)[:, :, None, None]

    def scalar(self, x):
        return _t(x).reshape(())

    def put(self, key: str, value: torch.Tensor):
        self.sd[key] = value

    def bn(self, p: str, params, stats):
        self.put(p + "weight", self.t(params["scale"]))
        self.put(p + "bias", self.t(params["bias"]))
        self.put(p + "running_mean", self.t(stats["mean"]))
        self.put(p + "running_var", self.t(stats["var"]))
        self.put(p + "num_batches_tracked", torch.tensor(0))

    def ln(self, p: str, params):
        self.put(p + "weight", self.t(params["scale"]))
        self.put(p + "bias", self.t(params["bias"]))

    def dense(self, p: str, params):
        self.put(p + "weight", self.lin_w(params["kernel"]))
        self.put(p + "bias", self.t(params["bias"]))

    def conv(self, p: str, params):
        self.put(p + "weight", self.conv_w(params["kernel"]))
        if "bias" in params:
            self.put(p + "bias", self.t(params["bias"]))

    def convbn(self, p: str, params, stats):
        self.conv(p + "block.conv.", params["conv"])
        self.bn(p + "block.bn.", params["bn"], stats["bn"])

    def bottlerep(self, p: str, params, stats):
        for c in ("conv1", "conv2"):
            self.convbn(f"{p}{c}.", params[c], stats[c])
        self.put(p + "alpha", self.t(params["alpha"]))

    def bepc3(self, p: str, params, stats, n: int):
        for c in ("cv1", "cv2", "cv3"):
            self.convbn(f"{p}{c}.", params[c], stats[c])
        m, ms = params["m"], stats["m"]
        self.bottlerep(p + "m.conv1.", m["conv1"], ms["conv1"])
        for i in range(max(n // 2 - 1, 0)):
            self.bottlerep(f"{p}m.block.{i}.", m[f"block_{i}"],
                           ms[f"block_{i}"])

    def bifusion(self, p: str, params, stats):
        for c in ("cv1", "cv2", "cv3", "downsample"):
            self.convbn(f"{p}{c}.", params[c], stats[c])
        up = params["upsample"]
        self.put(p + "upsample.upsample_transpose.weight", self.t(up["kernel"]))
        self.put(p + "upsample.upsample_transpose.bias", self.t(up["bias"]))

    # ---- the legacy bricks (nn/layers.RepVGGBlock, nn/yolo_world_pafpn,
    # nn/yolov5_head): mmcv ConvModule keys `<p>conv.*` / `<p>bn.*`, no
    # `block.`; each writer takes (prefix, params, batch_stats, ...)
    def convmodule(self, p: str, params, stats):
        self.conv(p + "conv.", params["conv"])
        self.bn(p + "bn.", params["bn"], stats["bn"])

    def repvgg(self, p: str, params, stats):
        """RepVGGBlock: the train form's branches, or the deploy conv."""
        if "reparam" in params:
            self.conv(p + "reparam.", params["reparam"])
            return
        for c in ("rbr_dense", "rbr_1x1"):
            self.convmodule(f"{p}{c}.", params[c], stats[c])
        if "rbr_identity" in params:
            self.bn(p + "rbr_identity.", params["rbr_identity"],
                    stats["rbr_identity"])

    def darknet_bottleneck(self, p: str, params, stats):
        for c in ("conv1", "conv2"):
            self.convmodule(f"{p}{c}.", params[c], stats[c])

    def csp2(self, p: str, params, stats, n: int):
        """CSPLayerWithTwoConv (JAX `block{i}` -> `blocks.{i}`)."""
        for c in ("main_conv", "final_conv"):
            self.convmodule(f"{p}{c}.", params[c], stats[c])
        for i in range(n):
            self.darknet_bottleneck(f"{p}blocks.{i}.", params[f"block{i}"],
                                    stats[f"block{i}"])

    def max_sigmoid_attn(self, p: str, params, stats):
        self.dense(p + "guide_fc.", params["guide_fc"])
        self.put(p + "bias", self.t(params["bias"]))
        if "scale" in params:
            self.put(p + "scale", self.t(params["scale"]))
        if "embed_conv" in params:
            self.convmodule(p + "embed_conv.", params["embed_conv"],
                            stats["embed_conv"])
        self.convmodule(p + "project_conv.", params["project_conv"],
                        stats["project_conv"])

    def max_csp(self, p: str, params, stats, n: int):
        """MaxSigmoidCSPLayerWithTwoConv: csp2 + the attention branch."""
        self.csp2(p, params, stats, n)
        self.max_sigmoid_attn(p + "attn_block.", params["attn_block"],
                              stats["attn_block"])

    def efficient_csp(self, p: str, params, stats, n: int):
        """EfficientCSPLayerWithTwoConv: csp2 + VanillaSigmoidBlock."""
        self.csp2(p, params, stats, n)
        self.convmodule(p + "attn_block.project_conv.",
                        params["attn_block"]["project_conv"],
                        stats["attn_block"]["project_conv"])

    def image_pool_attn(self, p: str, params, stats=None,
                        num_feats: int = 3):
        """ImagePoolingAttentionModule (no batch_stats)."""
        for i in range(num_feats):
            self.conv(f"{p}projections.{i}.conv.",
                      params[f"projection{i}"]["conv"])
        for name in ("query", "key", "value"):
            self.ln(f"{p}{name}.0.", params[f"{name}_ln"])
            self.dense(f"{p}{name}.1.", params[f"{name}_fc"])
        self.dense(p + "proj.", params["proj"])
        if "scale" in params:
            self.put(p + "scale", self.t(params["scale"]))

    def yolo_world_pafpn(self, p: str, params, stats, n_blocks: int,
                         num_levels: int = 3, dual: bool = False):
        for i in range(num_levels - 1):
            for ours, theirs in (("top_down", "top_down_layers"),
                                 ("bottom_up", "bottom_up_layers")):
                self.max_csp(f"{p}{theirs}.{i}.", params[f"{ours}{i}"],
                             stats[f"{ours}{i}"], n_blocks)
            self.convmodule(f"{p}downsample_layers.{i}.",
                            params[f"downsample{i}"],
                            stats[f"downsample{i}"])
        if dual:
            self.image_pool_attn(p + "text_enhancer.",
                                 params["text_enhancer"],
                                 num_feats=num_levels)

    def mmdet_csp(self, p: str, params, stats, n: int):
        """CSPLayer (C3; JAX `block{i}_conv{j}` -> `blocks.{i}.conv{j}`)."""
        for c in ("main_conv", "short_conv", "final_conv"):
            self.convmodule(f"{p}{c}.", params[c], stats[c])
        for i in range(n):
            for c in ("conv1", "conv2"):
                key = f"block{i}_{c}"
                self.convmodule(f"{p}blocks.{i}.{c}.", params[key],
                                stats[key])

    def yolov5_pafpn(self, p: str, params, stats, n_blocks: int):
        self.convmodule(p + "reduce_layers.2.", params["reduce2"],
                        stats["reduce2"])
        self.mmdet_csp(p + "top_down_layers.0.0.", params["top_down0"],
                       stats["top_down0"], n_blocks)
        self.convmodule(p + "top_down_layers.0.1.",
                        params["top_down0_reduce"],
                        stats["top_down0_reduce"])
        self.mmdet_csp(p + "top_down_layers.1.", params["top_down1"],
                       stats["top_down1"], n_blocks)
        for i in range(2):
            self.convmodule(f"{p}downsample_layers.{i}.",
                            params[f"downsample{i}"],
                            stats[f"downsample{i}"])
            self.mmdet_csp(f"{p}bottom_up_layers.{i}.",
                           params[f"bottom_up{i}"], stats[f"bottom_up{i}"],
                           n_blocks)

    def yolov8_pafpn(self, p: str, params, stats, n_blocks: int,
                     num_levels: int = 3):
        for i in range(num_levels - 1):
            for ours, theirs in (("top_down", "top_down_layers"),
                                 ("bottom_up", "bottom_up_layers")):
                self.csp2(f"{p}{theirs}.{i}.", params[f"{ours}{i}"],
                          stats[f"{ours}{i}"], n_blocks)
            self.convmodule(f"{p}downsample_layers.{i}.",
                            params[f"downsample{i}"],
                            stats[f"downsample{i}"])

    def yolov5_head(self, p: str, params, stats=None, num_levels: int = 3):
        """YOLOv5HeadModule: JAX `convs_pred_{i}` -> `convs_pred.{i}`."""
        for i in range(num_levels):
            self.conv(f"{p}convs_pred.{i}.", params[f"convs_pred_{i}"])


class _PathTree:
    """A stand-in for a flax tree: indexing extends the path, and every
    name is present (`jax_param_paths` keeps only the keys the port's
    module has)."""

    def __init__(self, path=()):
        self.path = path

    def __getitem__(self, name: str) -> "_PathTree":
        return _PathTree(self.path + (name,))

    def __contains__(self, name: str) -> bool:
        return True


class _PathWriter(_Writer):
    """Writes each port key's JAX path ("/"-joined) in place of its
    tensor."""

    def t(self, x):
        return "/".join(x.path)

    conv_w = lin_w = conv1x1_w = scalar = t


def from_jax_variables(variables: Mapping, cfg: ModelCfg) -> StateDict:
    """JAX detector `variables` ({"params", "batch_stats"} of numpy
    arrays) -> the port's WeDetectModule state dict (canonical keys)."""
    w = _Writer()
    _write_detector(w, variables["params"], variables["batch_stats"], cfg)
    return w.sd


def jax_param_paths(cfg: ModelCfg) -> Dict[str, str]:
    """Port key -> the JAX param path of the same tensor, "/"-joined as
    the JAX optimizer's masks read it ("neck/rep_p4/cv1/conv/kernel"),
    for every parameter of the port's WeDetectModule."""
    from wedetect_tpu_torch.models.wedetect import WeDetectModule

    w = _PathWriter()
    _write_detector(w, _PathTree(), _PathTree(("batch_stats",)), cfg)
    with torch.device("meta"):
        names = [n for n, _ in WeDetectModule(cfg).named_parameters()]
    missing = [n for n in names if n not in w.sd]
    if missing:
        raise KeyError(f"no JAX path for {missing[:5]}")
    return {n: w.sd[n] for n in names}


def _write_detector(w: _Writer, params, stats, cfg: ModelCfg) -> None:
    """Every entry of the detector, flax subtree -> port key."""

    bb = params["backbone"]
    p = "backbone.downsample_layers."
    w.conv(p + "0.0.", bb["stem_conv"])
    w.ln(p + "0.1.", bb["stem_norm"])
    for i in (1, 2, 3):
        w.ln(f"{p}{i}.0.", bb[f"down{i}_norm"])
        w.conv(f"{p}{i}.1.", bb[f"down{i}_conv"])
    for i, depth in enumerate(cfg.depths):
        for j in range(depth):
            blk = bb[f"stage{i}_block{j}"]
            bp = f"backbone.stages.{i}.{j}."
            w.conv(bp + "dwconv.", blk["dwconv"])
            w.ln(bp + "norm.", blk["norm"])
            w.dense(bp + "pwconv1.", blk["pwconv1"])
            w.dense(bp + "pwconv2.", blk["pwconv2"])
            w.put(bp + "gamma", w.t(blk["gamma"]))
    if cfg.backbone_down_proj:
        dm = params["down_mlp"]
        w.put("down_mlp.weight", w.conv1x1_w(dm["kernel"]))
        w.put("down_mlp.bias", w.t(dm["bias"]))

    nk, ns = params["neck"], stats["neck"]
    for ours, theirs in (("reduce0", "reduce_layer0"),
                         ("reduce1", "reduce_layer1"),
                         ("downsample2", "downsample2"),
                         ("downsample1", "downsample1")):
        w.convbn(f"neck.{theirs}.", nk[ours], ns[ours])
    for ours, theirs in (("bifusion0", "Bifusion0"),
                         ("bifusion1", "Bifusion1")):
        w.bifusion(f"neck.{theirs}.", nk[ours], ns[ours])
    for ours, theirs in (("rep_p4", "Rep_p4"), ("rep_p3", "Rep_p3"),
                         ("rep_n3", "Rep_n3"), ("rep_n4", "Rep_n4")):
        w.bepc3(f"neck.{theirs}.", nk[ours], ns[ours], cfg.neck_repeats)

    hd, hs = params["head"], stats["head"]
    for i in range(len(cfg.strides)):
        for branch, tname in (("cls", "cls_preds"), ("reg", "reg_preds")):
            tp = f"bbox_head.{tname}.{i}."
            for idx, name in ((0, "conv0"), (3, "conv1")):
                sub, st = hd[f"{branch}{i}_{name}"], hs[f"{branch}{i}_{name}"]
                w.conv(f"{tp}{idx}.", sub["conv"])
                w.bn(f"{tp}{idx + 1}.", sub["bn"], st["bn"])
            w.conv(f"{tp}6.", hd[f"{branch}{i}_pred"]["conv"])
        c, cp = hd[f"contrast{i}"], f"bbox_head.cls_contrasts.{i}."
        if "norm" in c:
            w.bn(cp + "norm.", c["norm"], hs[f"contrast{i}"]["norm"])
        w.put(cp + "bias", w.scalar(c["bias"]))
        w.put(cp + "logit_scale", w.scalar(c["logit_scale"]))

    if cfg.num_prompts:
        w.put("embeddings", w.t(params["embeddings"]))
        if cfg.use_mlp_adapter:
            w.dense("adapter.0.", params["adapter_fc1"])
            w.dense("adapter.2.", params["adapter_fc2"])


def from_jax_text_params(params: Mapping, cfg: TextCfg) -> StateDict:
    """JAX TextTower params (numpy) -> the port's TextTower state dict
    in HF keys (+ `head.*`)."""
    enc = params["encoder"]
    w = _Writer()
    e = "embeddings."
    w.put(e + "word_embeddings.weight",
          _t(enc["word_embeddings"]["embedding"]))
    w.put(e + "position_embeddings.weight",
          _t(enc["position_embeddings"]["embedding"]))
    w.put(e + "token_type_embeddings.weight",
          _t(enc["token_type_embeddings"]))
    w.ln(e + "LayerNorm.", enc["embeddings_ln"])
    for i in range(cfg.num_layers):
        lyr, p = enc[f"layer_{i}"], f"encoder.layer.{i}."
        att = lyr["attention"]
        for n in ("query", "key", "value"):
            w.dense(f"{p}attention.self.{n}.", att[n])
        w.dense(p + "attention.output.dense.", att["out"])
        w.ln(p + "attention.output.LayerNorm.", lyr["attention_ln"])
        w.dense(p + "intermediate.dense.", lyr["intermediate"])
        w.dense(p + "output.dense.", lyr["output"])
        w.ln(p + "output.LayerNorm.", lyr["output_ln"])
    w.dense("head.", params["head"])
    return w.sd


def from_jax_module(kind: str, variables: Mapping, **kw) -> StateDict:
    """One legacy module's JAX `variables` ({"params"[, "batch_stats"]},
    numpy) -> its port state dict. `kind` names the writer: "repvgg",
    "darknet_bottleneck", "csp2", "max_sigmoid_attn", "max_csp",
    "efficient_csp", "image_pool_attn" (num_feats), "yolo_world_pafpn"
    (n_blocks, dual), "mmdet_csp" (n), "yolov5_pafpn" (n_blocks),
    "yolov8_pafpn" (n_blocks), "yolov5_head" (num_levels)."""
    w = _Writer()
    getattr(w, kind)("", variables["params"],
                     variables.get("batch_stats", {}), **kw)
    return w.sd


def _clip_blocks(w: _Writer, params, prefix: str, layers: int) -> None:
    for i in range(layers):
        lyr, p = params[f"layer{i}"], f"{prefix}encoder.layers.{i}."
        w.ln(p + "layer_norm1.", lyr["ln1"])
        w.ln(p + "layer_norm2.", lyr["ln2"])
        for ours, theirs in (("q", "q_proj"), ("k", "k_proj"),
                             ("v", "v_proj"), ("out", "out_proj")):
            w.dense(f"{p}self_attn.{theirs}.", lyr[ours])
        w.dense(p + "mlp.fc1.", lyr["fc1"])
        w.dense(p + "mlp.fc2.", lyr["fc2"])


def from_jax_clip_text(params: Mapping, cfg) -> StateDict:
    """JAX ClipTextTower params (numpy) -> the port's ClipTextTower state
    dict in HF keys (`text_model.*`, `text_projection.weight`)."""
    w = _Writer()
    p = "text_model."
    _clip_blocks(w, params, p, cfg.layers)
    w.put(p + "embeddings.token_embedding.weight",
          _t(params["token_embedding"]["embedding"]))
    w.put(p + "embeddings.position_embedding.weight",
          _t(params["position_embedding"]))
    w.ln(p + "final_layer_norm.", params["final_ln"])
    w.put("text_projection.weight",
          _lin(params["text_projection"]["kernel"]))
    return w.sd


def from_jax_clip_vision(params: Mapping, cfg) -> StateDict:
    """JAX ClipVisionTower params (numpy) -> the port's ClipVisionTower
    state dict in HF keys (`vision_model.*`)."""
    w = _Writer()
    p = "vision_model."
    _clip_blocks(w, params, p, cfg.layers)
    w.put(p + "embeddings.patch_embedding.weight",
          _conv(params["patch_embedding"]["kernel"]))
    w.put(p + "embeddings.class_embedding", _t(params["class_embedding"]))
    w.put(p + "embeddings.position_embedding.weight",
          _t(params["position_embedding"]))
    w.ln(p + "pre_layrnorm.", params["pre_ln"])
    return w.sd
