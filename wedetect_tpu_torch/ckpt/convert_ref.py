"""WeDetect-Ref checkpoints for the port.

`models/ref.RefModules` carries the HF Qwen3-VL(-Grounding) key names
that `wedetect_tpu/ckpt/convert_ref.py` reads (`model.visual.*`,
`model.language_model.*`, the grounding extras under `model.`,
`out_proj.*`), so an HF checkpoint loads with `load_state_dict`.

`from_jax_ref_params` goes the other way from the JAX package: the
`{vision, text, embed, extras}` params of `wedetect_tpu.models.ref`
(as numpy) -> a port state dict, the exact inverse of
`convert_ref_model`, the untied `lm_head` included; with `mesh` (a
tensor-parallel rank's `parallel/mesh.TpMesh`), only that rank's slices
(`parallel/mesh.shard_ref_state`), cut on the host, for
`models/ref.tp_ref_model` to move to its card. Layouts: Dense
(in, out) -> Linear (out, in); the patch-embed Dense (C*T*P*P, hidden)
-> the checkpoint's Conv3d weight (hidden, C, T, P, P); ConvT2x (in,
out, 2, 2) unchanged; norm scales -> `weight`. `from_jax_decode_params`
carries a JAX decode-param tree (`models/quant.quantize_decode_params`,
int8 or packed int4) into the port's (`wedetect_tpu_torch/models/
quant.py`), codes and scales unchanged. `jax_param_paths` gives the same map as port key -> JAX path,
which the optimizer's per-path rules read (`train/optimizer.py`).
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

from wedetect_tpu_torch.nn.qwen3vl import RefCfg
from wedetect_tpu_torch.parallel.mesh import shard_ref_state

StateDict = Dict[str, torch.Tensor]


def _entries(cfg: RefCfg, lm_head: bool = True
             ) -> List[Tuple[str, Tuple[str, ...], str]]:
    """(port key, JAX param path, layout) of every tensor, the untied
    `lm_head` last (with `lm_head`). Layout "T": Dense kernel (in, out)
    -> Linear weight (out, in); "patch": the patch-embed Dense -> the
    Conv3d weight; "": as is."""
    v, t = cfg.vision, cfg.text
    out: List[Tuple[str, Tuple[str, ...], str]] = []

    def lin(key, path, bias=True):
        out.append((key + ".weight", path + ("kernel",), "T"))
        if bias:
            out.append((key + ".bias", path + ("bias",), ""))

    def norm(key, path, bias=True):
        out.append((key + ".weight", path + ("scale",), ""))
        if bias:
            out.append((key + ".bias", path + ("bias",), ""))

    def merger(key, path):
        norm(key + "norm", path + ("norm",))
        lin(key + "linear_fc1", path + ("fc1",))
        lin(key + "linear_fc2", path + ("fc2",))

    vp = "model.visual."
    out.append((vp + "patch_embed.proj.weight",
                ("vision", "patch_embed", "kernel"), "patch"))
    out.append((vp + "patch_embed.proj.bias",
                ("vision", "patch_embed", "bias"), ""))
    out.append((vp + "pos_embed.weight", ("vision", "pos_embed"), ""))
    for i in range(v.depth):
        b, pb = f"{vp}blocks.{i}.", ("vision", f"block{i}")
        norm(b + "norm1", pb + ("norm1",))
        norm(b + "norm2", pb + ("norm2",))
        lin(b + "attn.qkv", pb + ("qkv",))
        lin(b + "attn.proj", pb + ("proj",))
        lin(b + "mlp.linear_fc1", pb + ("fc1",))
        lin(b + "mlp.linear_fc2", pb + ("fc2",))
    merger(vp + "merger.", ("vision", "merger"))
    for j in range(len(v.deepstack_idx)):
        merger(f"{vp}deepstack_merger_list.{j}.", ("vision", f"deepstack{j}"))

    tp = "model.language_model."
    for i in range(t.layers):
        b, pl = f"{tp}layers.{i}.", ("text", f"layer{i}")
        norm(b + "input_layernorm", pl + ("input_ln",), bias=False)
        norm(b + "post_attention_layernorm", pl + ("post_ln",), bias=False)
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            lin(b + "self_attn." + name, pl + (name,), bias=False)
        norm(b + "self_attn.q_norm", pl + ("q_norm",), bias=False)
        norm(b + "self_attn.k_norm", pl + ("k_norm",), bias=False)
        for name in ("gate_proj", "up_proj", "down_proj"):
            lin(b + "mlp." + name, pl + (name,), bias=False)
    norm(tp + "norm", ("text", "norm"), bias=False)
    out.append((tp + "embed_tokens.weight",
                ("embed", "embed_tokens", "embedding"), ""))

    pe = ("extras",)
    for name in ("image_pos_projector", "object_vision_projector",
                 "object_pos_projector"):
        lin(f"model.{name}.0", pe + (name, "fc0"))
        lin(f"model.{name}.2", pe + (name, "fc1"))
    for name in ("first_scale_conv1", "first_scale_conv2",
                 "second_scale_conv"):
        out.append((f"model.{name}.weight", pe + (name, "kernel"), ""))
        out.append((f"model.{name}.bias", pe + (name, "bias"), ""))
    norm("model.first_scale_norm", pe + ("first_scale_norm",))
    lin("model.merge", pe + ("merge",))
    lin("out_proj", pe + ("out_proj",))
    if lm_head:
        lin("lm_head", ("lm_head",), bias=False)
    return out


def jax_param_paths(cfg: RefCfg) -> Dict[str, str]:
    """Port key -> the JAX param path of the same tensor, "/"-joined as
    the JAX optimizer's masks read it ("vision/block0/qkv/kernel")."""
    return {key: "/".join(path) for key, path, _ in _entries(cfg)}


def from_jax_ref_params(params: Mapping, cfg: RefCfg,
                        mesh=None) -> StateDict:
    """JAX Ref params (numpy leaves) -> port state dict (f32 tensors).
    A params["lm_head"]["kernel"] (the stage-1/2 untied head) becomes
    `lm_head.weight`, transposed: load it into RefModules(lm_head=True).
    With `mesh`, the slices of tensor-parallel rank mesh.tp_index."""
    v = cfg.vision
    out: StateDict = {}
    for key, path, layout in _entries(cfg, lm_head="lm_head" in params):
        x = params
        for name in path:
            x = x[name]
        x = np.asarray(x)
        if layout == "T":
            x = x.T
        elif layout == "patch":
            x = x.T.reshape(v.hidden, v.in_ch, v.temporal_patch, v.patch,
                            v.patch)
        out[key] = torch.tensor(np.asarray(x, np.float32))
    return out if mesh is None else shard_ref_state(out, mesh, cfg)


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


def from_jax_decode_params(tree: Mapping) -> Dict:
    """A JAX decode-param tree (numpy leaves: quantized {w8, scale} /
    {w4p, rscale, scale} leaves, or {kernel} ones) -> the port's: the
    quantized leaves as they are ((in, out) layout), a {kernel} as
    {weight} (out, in), a norm {scale} as its tensor, and the embedding
    table under "embed"."""
    def leaf(node):
        if "kernel" in node:
            return {"weight": torch.tensor(np.asarray(node["kernel"]).T)}
        if "scale" in node and len(node) == 1:
            return torch.tensor(np.asarray(node["scale"]))
        return {k: torch.tensor(np.asarray(v)) for k, v in node.items()}

    text = {name: (leaf(layer) if name == "norm"
                   else {k: leaf(v) for k, v in layer.items()})
            for name, layer in tree["text"].items()}
    out = {"text": text, "embed": torch.tensor(np.asarray(
        tree["embed"]["embed_tokens"]["embedding"]))}
    if "lm_head" in tree:
        out["lm_head"] = leaf(tree["lm_head"])
    return out
