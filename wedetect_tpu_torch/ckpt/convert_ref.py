"""WeDetect-Ref checkpoints for the port.

`models/ref.RefModules` carries the HF Qwen3-VL(-Grounding) key names
that `wedetect_tpu/ckpt/convert_ref.py` reads (`model.visual.*`,
`model.language_model.*`, the grounding extras under `model.`,
`out_proj.*`), so an HF checkpoint loads with `load_state_dict`.

`from_jax_ref_params` goes the other way from the JAX package: the
`{vision, text, embed, extras}` params of `wedetect_tpu.models.ref`
(as numpy) -> a port state dict, the exact inverse of
`convert_ref_model`. Layouts: Dense (in, out) -> Linear (out, in); the
patch-embed Dense (C*T*P*P, hidden) -> the checkpoint's Conv3d weight
(hidden, C, T, P, P); ConvT2x (in, out, 2, 2) unchanged; norm scales ->
`weight`.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Mapping

import numpy as np
import torch

from wedetect_tpu_torch.nn.qwen3vl import RefCfg

StateDict = Dict[str, torch.Tensor]


def _lin(out: StateDict, key: str, p: Mapping, bias: bool = True):
    out[key + ".weight"] = np.asarray(p["kernel"]).T
    if bias:
        out[key + ".bias"] = np.asarray(p["bias"])


def _norm(out: StateDict, key: str, p: Mapping, bias: bool = True):
    out[key + ".weight"] = np.asarray(p["scale"])
    if bias:
        out[key + ".bias"] = np.asarray(p["bias"])


def from_jax_ref_params(params: Mapping, cfg: RefCfg) -> StateDict:
    """JAX Ref params (numpy leaves) -> port state dict (f32 tensors)."""
    v, t = cfg.vision, cfg.text
    out: Dict[str, np.ndarray] = {}
    pv, pt = params["vision"], params["text"]
    vp = "model.visual."
    k = np.asarray(pv["patch_embed"]["kernel"]).T
    out[vp + "patch_embed.proj.weight"] = k.reshape(
        v.hidden, v.in_ch, v.temporal_patch, v.patch, v.patch)
    out[vp + "patch_embed.proj.bias"] = np.asarray(pv["patch_embed"]["bias"])
    out[vp + "pos_embed.weight"] = np.asarray(pv["pos_embed"])
    for i in range(v.depth):
        b, pb = f"{vp}blocks.{i}.", pv[f"block{i}"]
        _norm(out, b + "norm1", pb["norm1"])
        _norm(out, b + "norm2", pb["norm2"])
        _lin(out, b + "attn.qkv", pb["qkv"])
        _lin(out, b + "attn.proj", pb["proj"])
        _lin(out, b + "mlp.linear_fc1", pb["fc1"])
        _lin(out, b + "mlp.linear_fc2", pb["fc2"])

    def merger(key, p):
        _norm(out, key + "norm", p["norm"])
        _lin(out, key + "linear_fc1", p["fc1"])
        _lin(out, key + "linear_fc2", p["fc2"])

    merger(vp + "merger.", pv["merger"])
    for j in range(len(v.deepstack_idx)):
        merger(f"{vp}deepstack_merger_list.{j}.", pv[f"deepstack{j}"])

    tp = "model.language_model."
    for i in range(t.layers):
        b, pl = f"{tp}layers.{i}.", pt[f"layer{i}"]
        _norm(out, b + "input_layernorm", pl["input_ln"], bias=False)
        _norm(out, b + "post_attention_layernorm", pl["post_ln"],
              bias=False)
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            _lin(out, b + "self_attn." + name, pl[name], bias=False)
        _norm(out, b + "self_attn.q_norm", pl["q_norm"], bias=False)
        _norm(out, b + "self_attn.k_norm", pl["k_norm"], bias=False)
        for name in ("gate_proj", "up_proj", "down_proj"):
            _lin(out, b + "mlp." + name, pl[name], bias=False)
    _norm(out, tp + "norm", pt["norm"], bias=False)
    out[tp + "embed_tokens.weight"] = np.asarray(
        params["embed"]["embed_tokens"]["embedding"])

    pe = params["extras"]
    for name in ("image_pos_projector", "object_vision_projector",
                 "object_pos_projector"):
        _lin(out, f"model.{name}.0", pe[name]["fc0"])
        _lin(out, f"model.{name}.2", pe[name]["fc1"])
    for name in ("first_scale_conv1", "first_scale_conv2",
                 "second_scale_conv"):
        out[f"model.{name}.weight"] = np.asarray(pe[name]["kernel"])
        out[f"model.{name}.bias"] = np.asarray(pe[name]["bias"])
    _norm(out, "model.first_scale_norm", pe["first_scale_norm"])
    _lin(out, "model.merge", pe["merge"])
    _lin(out, "out_proj", pe["out_proj"])
    return {k: torch.tensor(np.asarray(a, np.float32))
            for k, a in out.items()}


def load_hf_state_dict(checkpoint_dir: str) -> StateDict:
    """Every tensor of the `*.safetensors` files of an HF checkpoint
    directory, on the CPU (safetensors is imported here, on use)."""
    from safetensors.torch import load_file

    files = sorted(glob.glob(os.path.join(checkpoint_dir, "*.safetensors")))
    if not files:
        raise FileNotFoundError(f"no *.safetensors in {checkpoint_dir}")
    sd: StateDict = {}
    for f in files:
        sd.update(load_file(f, device="cpu"))
    return sd
