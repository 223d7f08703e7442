"""Weight-only int8 / int4 quantization for the generation decode path.

Port of `wedetect_tpu/models/quant.py`. A decode step streams every
decoder weight once for a handful of token rows, so it is bound by the
bytes it reads; weight-only int8 stores each matmul kernel as int8
codes with a per-output-channel f32 scale, int4 as nibble-packed codes
with rank-1 two-sided scales (`w ~= diag(rscale) @ q @ diag(scale)`).

The decode-param tree (`decode_params`, what `models/ref_generate`,
`models/ref_speculative` and `models/serve` read per token):

    {"text": {"layer{i}": {"q_proj": leaf, ..., "down_proj": leaf,
                           "input_ln": w, "post_ln": w, "q_norm": w,
                           "k_norm": w}, "norm": w},
     "embed": (vocab, hidden) table, ["lm_head": leaf], ["tp": group]}

A full-precision leaf is `{"weight": (out, in)}`, the module's own
Linear weight (no copy); a quantized leaf keeps JAX's (in, out) layout,
so its codes and scales are bitwise those of the JAX package from the
same f32 weights: `{"w8", "scale"}` (int8), `{"w4p", "rscale",
"scale"}` (packed int4), or `{"w4", "rscale", "scale"}` (the int8 codes
of an int4 leaf, unpacked once per call by `prepare_decode_params`;
torch has no 4-bit type). `matmul_any` computes `(y @ w8) * scale` and
`((y * rscale) @ q) * scale` as plain torch products: in the JAX package
they are XLA ops outside any Pallas kernel. Unlike XLA, torch does not
fuse the int8 -> compute-dtype convert into the product, so each call
materializes the converted kernel.

Scope is decode only: prefill keeps the model's full-precision weights.
The LM head is always quantized with the layers; a tied head gets a
quantized transposed copy of the embedding, whose table stays for the
token lookup. `quantize_decode_params(..., calib=...)` takes the
per-matmul activation RMS statistics of `models/quant_calib` for the
activation-weighted int4 fit, which runs on the weights' device.

A tensor-parallel model's tree (`decode_params` of RefModules(tp=...))
holds the rank's slices and its group under "tp": the decode layers sum
their row-parallel products over it (`matmul_any(tp=)`: the partial
products first, then the output scale) and gather the tied head's
logits. `quantize_decode_params` of such a model gives each rank, bitwise,
its slice of the one-process tree:

- column layers (q, k, v, gate, up, and the tied head's copy over the
  rank's vocabulary range): int8 `w8` and `scale` by output column;
  int4 `w4p` and `scale` by output column, `rscale` whole;
- row layers (o_proj, down_proj): int8 `w8` by contraction row, its
  per-output `scale` the group's MAX of the rows' absmax; int4 `w4p` at
  h / (2 tp) packed rows (rows 2i and 2i + 1 stay in one byte), `rscale`
  with the rows, `scale` whole;
- the alternating int4 fit takes the group's MAX on whichever axis is
  sliced (`row_group` / `col_group` of quantize_weight4);
- the calibrated int4 fit sums errors over the contraction and over
  every column: each matrix is gathered whole (one at a time), fit as in
  one process and sliced, so `calib` holds whole widths.

JAX's `ref_tp_sharding` replicates a quantized tree (its leaves are not
named `kernel`); the port slices it, so a rank holds 1 / tp of the codes,
the layout its decode layers read.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from wedetect_tpu_torch.ops.int8 import true_div
from wedetect_tpu_torch.parallel import mesh as pmesh
from wedetect_tpu_torch.parallel.collectives import MAX, fsdp_slice

_LAYER_MATMULS = ("q_proj", "k_proj", "v_proj", "o_proj",
                  "gate_proj", "up_proj", "down_proj")
# the row-parallel matmuls of a tensor-parallel layer (parallel/mesh.py)
_ROW_MATMULS = ("o_proj", "down_proj")


def _group_max(group, t: torch.Tensor) -> torch.Tensor:
    """t's MAX over `group` in place (t where group is None)."""
    if group is not None:
        group.all_reduce(t, op=MAX)
    return t


def quantize_weight(w: torch.Tensor, axis: int = 0, row_group=None) -> Dict:
    """Symmetric per-channel absmax int8 of an (in, out) kernel:
    {w8, scale} with w8 * scale ~= w, scale per output channel (the
    max runs over `axis`, the contraction axis). `row_group`: the
    tensor-parallel group over which the contraction rows are sliced
    (the absmax is its MAX)."""
    wf = w.float()
    amax = _group_max(row_group, wf.abs().amax(dim=axis, keepdim=True))
    scale = true_div(torch.clamp(amax, min=1e-12), 127.0)
    w8 = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return {"w8": w8, "scale": scale.squeeze(axis)}


def quantize_weight4(w: torch.Tensor, axis: int = 0, iters: int = 2,
                     act_rms=None, alphas=(0.0, 0.25, 0.5),
                     clip_grid=(1.0, 0.95, 0.9, 0.85, 0.8, 0.7),
                     row_group=None, col_group=None) -> Dict:
    """Rank-1 two-sided symmetric int4 of an (in, out) kernel:
    {w4p, rscale, scale} with diag(rscale) @ unpack(w4p) @ diag(scale)
    ~= w. Scales by alternating row/column absmax (the last column pass
    maps every column's absmax to +-7, so no code clips); w4p packs
    contraction rows 2i (low nibble) and 2i + 1 (high). `act_rms` (in,)
    switches to the activation-weighted fit (`_fit_int4_calibrated`),
    which takes whole kernels. `row_group` / `col_group`: the
    tensor-parallel group over which w's rows / columns are sliced; the
    column absmax (c) / row absmax (r) is its MAX."""
    assert axis == 0, "contraction axis must be 0"
    if act_rms is not None:
        assert row_group is None and col_group is None, \
            "the calibrated fit takes a whole kernel"
        return _fit_int4_calibrated(
            w.float(),
            np.asarray(torch.as_tensor(act_rms).float().cpu(), np.float32),
            iters, alphas, clip_grid)
    wf = w.float()
    h, _ = wf.shape
    assert h % 2 == 0, "contraction dim must be even to nibble-pack"
    wa = torch.clamp(wf.abs(), min=1e-12)
    r = torch.ones(h, dtype=torch.float32, device=wf.device)
    for _ in range(iters):
        c = _group_max(row_group, (wa / r[:, None]).amax(dim=0))
        r = _group_max(col_group, (wa / c[None, :]).amax(dim=1))
    # colmax == 1 exactly
    c = _group_max(row_group, (wa / r[:, None]).amax(dim=0))
    q = torch.clamp(torch.round(wf / (r[:, None] * c[None, :]) * 7.0),
                    -7, 7).to(torch.int8)
    return {"w4p": pack_int4(q), "rscale": r, "scale": true_div(c, 7.0)}


def _fit_int4_calibrated(wf, act_rms, iters, alphas, clip_grid,
                         col_chunk=4096):
    """Activation-weighted int4 fit of an (in, out) f32 kernel, on its
    device (a one-time set-up step; column-chunked so that the LM head
    never holds more than one (in, col_chunk) temporary a candidate):
    minimizes sum_io a_i^2 (w_io - deq_io)^2 over AWQ-style row
    re-weightings `alphas` and per-column clip factors `clip_grid`;
    alpha 0, beta 1 (the plain fit) is always a candidate. The same
    {w4p, rscale, scale} leaf as quantize_weight4.

    The JAX package fits in numpy on the host. The elementwise work here
    is the same f32 arithmetic (the activation weights `a ** alpha`
    still come from numpy); the squared errors are summed in float64,
    where numpy sums them in f32, so a candidate can differ from JAX's
    choice only where two candidates' errors tie within f32 rounding."""
    h, o = wf.shape
    assert h % 2 == 0, "contraction dim must be even to nibble-pack"
    dev = wf.device
    a = np.maximum(act_rms, 1e-12).astype(np.float32)
    a = a / a.mean()
    t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    w2 = t((a * a)[:, None])                  # row weights of the MSE
    best_total, best = np.inf, None
    for alpha in alphas:
        s_act = t(a ** np.float32(alpha))
        wa = torch.clamp(wf.abs() * s_act[:, None], min=1e-12)
        r = torch.ones(h, dtype=torch.float32, device=dev)
        for _ in range(iters):
            c = (wa / r[:, None]).amax(dim=0)
            r = (wa / c[None, :]).amax(dim=1)
        c = (wa / r[:, None]).amax(dim=0)
        del wa
        r = r / s_act                     # undo the fit re-weighting
        codes = torch.empty((h, o), dtype=torch.int8, device=dev)
        scale = torch.empty(o, dtype=torch.float32, device=dev)
        total = torch.zeros((), dtype=torch.float64, device=dev)
        for st in range(0, o, col_chunk):
            sl = slice(st, min(st + col_chunk, o))
            wb = wf[:, sl]
            err_best = torch.full((wb.shape[1],), float("inf"),
                                  dtype=torch.float64, device=dev)
            for beta in clip_grid:
                sc = true_div(c[sl] * float(np.float32(beta)), 7.0)
                cd = torch.clamp(torch.round(wb / (r[:, None] * sc[None, :])),
                                 -7, 7)
                err = ((wb - r[:, None] * cd * sc[None, :]).square()
                       * w2).double().sum(dim=0)
                upd = err < err_best
                err_best = torch.where(upd, err, err_best)
                codes[:, sl] = torch.where(upd[None, :], cd.to(torch.int8),
                                           codes[:, sl])
                scale[sl] = torch.where(upd, sc, scale[sl])
            total += err_best.sum()
        if float(total) < best_total:
            best_total = float(total)
            best = (codes, r, scale)
    codes, r, scale = best
    return {"w4p": pack_int4(codes), "rscale": r, "scale": scale}


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """(H, O) int8 codes in [-8, 7] -> (H/2, O) int8: row 2i in the low
    nibble and row 2i + 1 in the high nibble of byte i."""
    qq = q.view(torch.uint8).reshape(q.shape[0] // 2, 2, q.shape[1])
    packed = (qq[:, 0] & 0x0F) | ((qq[:, 1] & 0x0F) << 4)
    return packed.view(torch.int8)


def unpack_int4(w4p: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_int4: (H/2, O) packed -> (H, O) int8 codes,
    sign-extended from each nibble."""
    x = w4p.to(torch.int32)
    lo = ((x & 0x0F) ^ 8) - 8
    hi = x >> 4                                    # arithmetic
    h2, o = w4p.shape
    return torch.stack([lo, hi], dim=1).reshape(2 * h2, o).to(torch.int8)


def matmul_any(y: torch.Tensor, leaf: Dict, dt, tp=None) -> torch.Tensor:
    """y @ kernel in compute dtype `dt` for a full-precision ({weight}),
    int8 ({w8, scale}), packed-int4 ({w4p, rscale, scale}) or unpacked
    int4 ({w4, rscale, scale}) leaf. The scales ride the activation
    (rscale, constant along its row) and the output (scale):
    ((y * rscale) @ q) * scale == y @ (diag(rscale) q diag(scale)).
    `tp`: the group over which a row-parallel leaf's contraction is
    sliced; the partial products are summed over it
    (parallel/mesh.row_sum) before the output scale."""
    if "w8" in leaf:
        return pmesh.row_sum(tp, y @ leaf["w8"].to(dt)) \
            * leaf["scale"].to(dt)
    if "w4" in leaf or "w4p" in leaf:
        q4 = leaf["w4"] if "w4" in leaf else unpack_int4(leaf["w4p"])
        return pmesh.row_sum(tp, (y * leaf["rscale"].to(dt))
                             @ q4.to(dt)) * leaf["scale"].to(dt)
    return pmesh.row_sum(tp, F.linear(y, leaf["weight"].to(dt)))


def prepare_decode_params(dp: Dict) -> Dict:
    """Unpack every packed-int4 leaf to int8 codes once, before a decode
    loop, so that each step reads the codes; other trees pass through."""
    def walk(node):
        if isinstance(node, dict):
            if "w4p" in node:
                return {"w4": unpack_int4(node["w4p"]),
                        "rscale": node["rscale"], "scale": node["scale"]}
            return {k: walk(v) for k, v in node.items()}
        return node
    return walk(dp)


def decode_params(model) -> Dict:
    """The full-precision decode-param tree of a RefModules: references
    to the model's own tensors, in its dtype (a tensor-parallel model's
    slices, with its group under "tp")."""
    lm = model.model.language_model
    text = {}
    for i, layer in enumerate(lm.layers):
        a, m = layer.self_attn, layer.mlp
        p = {"input_ln": layer.input_layernorm.weight,
             "post_ln": layer.post_attention_layernorm.weight,
             "q_norm": a.q_norm.weight, "k_norm": a.k_norm.weight}
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            p[name] = {"weight": getattr(a, name).weight}
        for name in ("gate_proj", "up_proj", "down_proj"):
            p[name] = {"weight": getattr(m, name).weight}
        text[f"layer{i}"] = p
    text["norm"] = lm.norm.weight
    out = {"text": text, "embed": lm.embed_tokens.weight}
    if getattr(model, "lm_head", None) is not None:
        out["lm_head"] = {"weight": model.lm_head.weight}
    if getattr(model, "tp", None) is not None:
        out["tp"] = model.tp
    return out


def check_decode_tree(tree: Dict, tp) -> None:
    """Raise unless the decode tree belongs to a model on the group `tp`
    (None: one process): a tensor-parallel model decodes from its own
    slices (decode_params or quantize_decode_params of that model)."""
    if tree.get("tp") is not tp:
        raise ValueError(
            "the decode tree was not built from this model's layout: pass "
            "quantize_decode_params(model) of the model that serves")


def _slice_leaf(leaf: Dict, row: bool, group) -> Dict:
    """A rank's slice of a whole quantized leaf: by contraction row (w8 or
    w4p rows, rscale; `row`) or by output column (codes and scale)."""
    def cut(name, t):
        if row:
            return t if name == "scale" else fsdp_slice(t, 0, group.index,
                                                        group.size)
        return t if name == "rscale" else fsdp_slice(t, t.ndim - 1,
                                                     group.index, group.size)
    return {k: cut(k, v).contiguous() for k, v in leaf.items()}


@torch.no_grad()
def quantize_decode_params(model_or_tree, bits: int = 8,
                           calib: Optional[Dict] = None) -> Dict:
    """The quantized decode-param tree of a RefModules (or of its
    `decode_params` tree): the seven matmuls of every text layer and the
    LM head to int8 (per-output-channel scales) or int4 (`bits=4`);
    norms and the embedding table pass through. A tied head quantizes
    the transposed embedding (one scale per vocab row). `calib` (int4
    only): {"text": {"layer{i}": {matmul: (in,)}}, "lm_head": (in,)}
    activation RMS for quantize_weight4's weighted fit; missing entries
    take the plain fit. A tensor-parallel model's tree is this rank's
    slice of the one-process tree, with its group under "tp" (module
    docstring; every rank of the group calls this together), and its
    `calib` holds whole widths."""
    assert bits in (8, 4), bits
    assert calib is None or bits == 4, \
        "calibration applies to the int4 fit only (int8 is plain absmax)"
    params = (model_or_tree if isinstance(model_or_tree, dict)
              else decode_params(model_or_tree))
    tp = params.get("tp")

    def qw(kernel, rms, sliced=None):
        """The leaf of an (in, out) kernel; `sliced` "row" or "column":
        this rank holds that slice of it over tp (module docstring)."""
        row_group = tp if sliced == "row" else None
        col_group = tp if sliced == "column" else None
        if bits == 8:
            return quantize_weight(kernel, axis=0, row_group=row_group)
        if rms is None or tp is None or sliced is None:
            return quantize_weight4(kernel, axis=0, act_rms=rms,
                                    row_group=row_group, col_group=col_group)
        # (in, out): gathered by output column, or by row through its
        # transpose (parallel/mesh.gather_vocab gathers the last axis)
        whole = (pmesh.gather_vocab(kernel.contiguous(), tp)
                 if sliced == "column" else
                 pmesh.gather_vocab(kernel.t().contiguous(), tp).t())
        leaf = quantize_weight4(whole, axis=0, act_rms=rms)
        del whole
        return _slice_leaf(leaf, sliced == "row", tp)

    def sliced(k):
        if tp is None:
            return None
        return "row" if k in _ROW_MATMULS else "column"

    calib = calib or {}
    ctext = calib.get("text", {})
    qtext = {}
    for name, layer in params["text"].items():
        if not name.startswith("layer"):
            qtext[name] = layer          # the final norm
            continue
        crms = ctext.get(name, {})
        qtext[name] = {k: (qw(leaf["weight"].float().t(), crms.get(k),
                              sliced(k))
                           if k in _LAYER_MATMULS else leaf)
                       for k, leaf in layer.items()}
    out = {"text": qtext, "embed": params["embed"]}
    head = params.get("lm_head")
    if head is not None:          # an untied head is whole on every rank
        out["lm_head"] = qw(head["weight"].float().t(),
                            calib.get("lm_head"))
    else:                         # the tied table: the rank's vocabulary
        out["lm_head"] = qw(params["embed"].float().t(),
                            calib.get("lm_head"),
                            None if tp is None else "column")
    if tp is not None:
        out["tp"] = tp
    return out


def dequantize_decode_params(qparams: Dict) -> Dict:
    """Inverse of quantize_decode_params up to rounding: a
    full-precision {weight} tree (the exact-mechanics oracle)."""
    def walk(node):
        if isinstance(node, dict):
            if "w8" in node:
                k = node["w8"].float() * node["scale"].float()
                return {"weight": k.t().contiguous()}
            if "w4p" in node:
                q = unpack_int4(node["w4p"]).float()
                k = node["rscale"][:, None] * q * node["scale"][None, :]
                return {"weight": k.t().contiguous()}
            return {k: walk(v) for k, v in node.items()}
        return node
    return walk(qparams)


def quantized_bytes(qparams: Dict) -> int:
    """Total bytes of the tree's tensors (diagnostic; a tensor-parallel
    tree's are this rank's)."""
    def walk(node):
        if isinstance(node, dict):
            return sum(walk(v) for v in node.values())
        if isinstance(node, torch.Tensor):
            return node.numel() * node.element_size()
        return 0                  # the tree's group
    return walk(qparams)
