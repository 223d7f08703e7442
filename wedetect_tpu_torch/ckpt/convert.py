"""Checkpoints for the port.

The port's modules carry the reference checkpoint's canonical torch key
names, so loading a reference `.pth` is a key remap
(`canonicalize_torch_keys`, copied from `wedetect_tpu.ckpt.convert`)
and `load_state_dict(strict=True)`.

`from_jax_variables` goes the other way from the JAX package: flax
`variables` (as numpy) -> a port state dict, the exact inverse of
`wedetect_tpu.ckpt.convert.convert_detector`; `from_jax_text_params`
inverts `wedetect_tpu.nn.xlmr.convert_hf_text_tower`. Layouts:
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
