"""Grouped-KV flash attention forward, rectangular end-aligned causal:
kernel K2 of the port.

Replaces `wedetect_tpu/ops/flash_gqa.py` (`gqa_flash_attention` and its
Pallas forward kernel `_fwd_kernel`). Every Qwen3-VL decoder layer calls
it through `ops/attention.gqa_attention`: square causal over the shared
prefix (S = Lk = P), rectangular causal for the suffix rows that attend
[prefix KV; own KV] (Lk = P + S, query i at key position Lk - S + i).

Contract (`gqa_flash_attention_plain`, and the kernel on the card):
q (B, S, H, D); k, v (B, Lk, KVH, D) pre-repeat, query head j reads kv
head j // (H // KVH); kv_valid (B, Lk). Logits q.k * sm_scale in f32,
f32 softmax, O in the input dtype; with `return_lse` also the per-row
logsumexp (B, KVH, S * G) in the folded-row order (row r = query
position r // G, head r % G of the group), f32.

Which keys a row sees follows the Pallas kernel's tiling. With JAX's
bq = _pick_bq(S, G) and bk = _pick_bk(Lk), the row of query i scans
keys [0, F) with F = min(Lk, bk * ceil((Lk - S + (i // bq + 1) * bq)
/ bk)) when causal (Lk when not): keys at or past F are absent; a key
below F that is invalid or causally later has logit -1e30 (not -inf).
So a row whose scanned keys are all masked returns the mean of V over
them, not 0; for every row with a valid key, F changes nothing.

`gqa_flash_attention` launches a CUDA kernel on CUDA tensors and runs
the plain version on CPU tensors; there is no fallback. The kernel goes
by type and shape (`fwd_route`): bf16 at D = 128 with G dividing 128
launches `csrc/flash_gqa_sm90.cu:gqa_flash_fwd_sm90` (wgmma tiles fed by
TMA); f32 at D = 128 `csrc/flash_gqa_f32.cu:gqa_flash_fwd_f32` (FFMA
register tiles fed by cp.async, walking only the key tiles the skip rule
`fwd_tile_walked` keeps); f32 and bf16 at other shapes (D = 256, 384,
512) the SIMT `csrc/flash_attn.cu:gqa_flash_fwd`. It is differentiable
in q, k and v
(a `torch.autograd.Function`, the JAX package's custom VJP): the
forward saves q, k, v, kv_valid, O and lse, and the backward
(`gqa_flash_attention_bwd`) launches kernels K2-bwd-dq and K2-bwd-dkdv
on CUDA tensors and runs `gqa_flash_attention_bwd_plain` on CPU
tensors. Those go by type and shape too (`dq_route`, `dkdv_route`): f32
at D = 128 to `csrc/flash_gqa_bwd_f32.cu` (FFMA register tiles fed by
cp.async, walking only the tiles the skip rule `dkdv_tile_walked`
keeps); bf16 at D = 128 with G dividing 64 to
`csrc/flash_gqa_bwd_sm90.cu` (wgmma + TMA, `bwd_route`); the other
shapes (D = 64, 256, 384, 512; other bf16 group sizes) to the SIMT
`csrc/flash_attn_bwd.cu`. delta = rowsum(dO * O) is plain torch in both,
as in JAX (`_bwd_grouped`).

Head dims on the card. `supports` is JAX's rule (any D % 128 == 0), and
the SIMT kernels are built for every such D up to 512 (128, 256, 384
and 512, beside 64), so K2 pads nothing. Above 512 a CUDA input raises
before any launch: a deliberate difference from the Pallas kernel,
which tiles any D % 128 == 0. CPU tensors take any D that `supports`
takes.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from wedetect_tpu_torch.ops.flash_attention import SIMT_HEAD_DIMS

_NEG = -1e30


def _pick_bq(s: int, g: int) -> int:
    """Query-position block of the Pallas kernel (flash_gqa._pick_bq)."""
    want = max(256 // g, 1) if g <= 2 else max(512 // g, 1)
    for bq in (want, 128, 64, 32, 16, 8, 4, 2, 1):
        if s % bq == 0 and bq * g >= 8:
            return bq
    return s


def _pick_bk(lk: int) -> int:
    """Key block of the Pallas kernel (flash_gqa._pick_bk); 0 = none."""
    for bk in (512, 256, 128):
        if lk % bk == 0:
            return bk
    return 0


def supports(s: int, lk: int, d: int, g: int) -> bool:
    """The JAX kernel's tiling rule: both packages route alike."""
    bq = _pick_bq(s, g)
    return (d % 128 == 0 and _pick_bk(lk) != 0 and s % bq == 0
            and bq * g >= 8)


def _check(q, k, v, causal):
    b, s, h, d = q.shape
    lk, kvh = k.shape[1], k.shape[2]
    if h % kvh:
        raise ValueError(f"q heads {h} not a multiple of kv heads {kvh}")
    if causal and lk < s:
        raise ValueError(f"causal needs Lk >= S ({lk} < {s})")
    if not supports(s, lk, d, h // kvh):
        raise ValueError(
            f"untileable shape: S={s}, Lk={lk}, D={d}, G={h // kvh} "
            "(Lk must be a multiple of 128, D of 128)")


def row_frontier(s: int, lk: int, g: int, causal: bool,
                 device=None) -> torch.Tensor:
    """(S,) int64: the key count F each query position scans."""
    i = torch.arange(s, device=device)
    if not causal:
        return torch.full((s,), lk, dtype=torch.int64, device=device)
    bq, bk = _pick_bq(s, g), _pick_bk(lk)
    end = (lk - s) + (i // bq + 1) * bq
    return torch.clamp((end + bk - 1) // bk * bk, max=lk)


def _acc_dtype(q):
    """The plain versions' accumulation type: f32, or f64 for f64
    inputs (gradcheck)."""
    return torch.float64 if q.dtype == torch.float64 else torch.float32


def _masked_logits(q, k, kv_valid, causal, sm_scale):
    """(B, KVH, G, S, Lk) f32 logits: -1e30 where the mask rejects a
    scanned key, -inf past the row's frontier."""
    acc = _acc_dtype(q)
    b, s, h, d = q.shape
    lk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    dev = q.device
    qpos = (lk - s if causal else 0) + torch.arange(s, device=dev)
    kpos = torch.arange(lk, device=dev)
    present = kpos[None, :] < row_frontier(s, lk, g, causal, dev)[:, None]
    ok = torch.ones((b, s, lk), dtype=torch.bool, device=dev)
    if causal:
        ok = ok & (kpos[None, :] <= qpos[:, None])[None]
    if kv_valid is not None:
        ok = ok & kv_valid.to(torch.bool)[:, None, :]
    qg = q.reshape(b, s, kvh, g, d).to(acc)
    logits = torch.einsum("bskgd,blkd->bkgsl", qg, k.to(acc)) * sm_scale
    logits = torch.where(ok[:, None, None], logits, _NEG)
    return logits.masked_fill(~present, float("-inf"))


def gqa_flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              kv_valid: Optional[torch.Tensor] = None,
                              sm_scale: Optional[float] = None,
                              return_lse: bool = False):
    """The kernel's function in plain PyTorch (module docstring)."""
    _check(q, k, v, causal)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    logits = _masked_logits(q, k, kv_valid, causal, sm_scale)
    o, lse = fwd_plain_from_logits(logits, v, q.dtype)
    return (o, lse) if return_lse else o


def fwd_plain_from_logits(logits: torch.Tensor, v: torch.Tensor,
                          dtype: torch.dtype):
    """(O (B, S, H, D) in `dtype`, lse (B, KVH, S * G)) of the plain
    forward from its logits (B, KVH, G, S, Lk): -1e30 where masked, -inf
    where absent (`_masked_logits`)."""
    acc = torch.float64 if logits.dtype == torch.float64 else torch.float32
    b, kvh, g, s, _ = logits.shape
    d = v.shape[-1]
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(-1, keepdim=True)                       # (B, KVH, G, S, 1)
    # the kernel casts p to V's dtype before the p.V product
    o = torch.einsum("bkgsl,blkd->bkgsd", p.to(v.dtype).to(acc),
                     v.to(acc))
    o = (o / l).permute(0, 3, 1, 2, 4).reshape(b, s, kvh * g, d).to(dtype)
    lse = (m + torch.log(l))[..., 0].permute(0, 1, 3, 2).reshape(
        b, kvh, s * g)
    return o, lse


def row_delta(o: torch.Tensor, do: torch.Tensor, kvh: int) -> torch.Tensor:
    """delta = rowsum(dO * O) in f32, (B, KVH, S * G) in the folded-row
    order of lse (JAX `_bwd_grouped`)."""
    acc = _acc_dtype(o)
    b, s, h, _ = o.shape
    g = h // kvh
    dl = (do.to(acc) * o.to(acc)).sum(-1)             # (B, S, H)
    return dl.reshape(b, s, kvh, g).permute(0, 2, 1, 3).reshape(
        b, kvh, s * g).contiguous()


def gqa_flash_attention_bwd_plain(q, k, v, kv_valid, o, lse, do, causal,
                                  sm_scale):
    """The backward kernels' function in plain PyTorch: (dq, dk, dv).

    The Pallas kernels' formulas (flash_gqa.py `_dq_kernel`,
    `_dkdv_kernel`): p = exp(s - lse) with the forward's -1e30 fill and
    frontier, ds = p * (dO.V^T - delta) * sm_scale, dv = p^T.dO with p
    cast to dO's dtype, dk = ds^T.Q and dq = ds.K with ds cast to the
    input dtype; f32 sums, dq in q's dtype, dk and dv in k's."""
    p, ds = bwd_plain_weights(q, k, v, kv_valid, o, lse, do, causal,
                              sm_scale)
    return bwd_plain_products(q, k, v, do, p, ds)


def bwd_plain_weights(q, k, v, kv_valid, o, lse, do, causal, sm_scale):
    """p and ds of the plain backward, each (B, KVH, G, S, Lk) in the
    accumulation type: p = exp(s - lse) with the forward's -1e30 fill and
    frontier (0 past it), ds = p * (dO.V^T - delta) * sm_scale."""
    acc = _acc_dtype(q)
    _check(q, k, v, causal)
    b, s, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    logits = _masked_logits(q, k, kv_valid, causal, sm_scale)
    lse_g = lse.reshape(b, kvh, s, g).permute(0, 1, 3, 2)[..., None]
    p = torch.exp(logits - lse_g)                     # (B, KVH, G, S, Lk)
    delta = row_delta(o, do, kvh).reshape(b, kvh, s, g).permute(
        0, 1, 3, 2)[..., None]
    dog = do.reshape(b, s, kvh, g, d)
    dp = torch.einsum("bskgd,blkd->bkgsl", dog.to(acc), v.to(acc))
    return p, p * (dp - delta) * sm_scale


def bwd_plain_products(q, k, v, do, p, ds):
    """(dq, dk, dv) of the plain backward from its p and ds: dv = p^T.dO
    with p cast to dO's dtype, dk = ds^T.Q and dq = ds.K with ds cast to
    the input dtype; f32 sums, dq in q's dtype, dk in k's, dv in v's."""
    acc = _acc_dtype(q)
    b, s, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    dog = do.reshape(b, s, kvh, g, d)
    qg = q.reshape(b, s, kvh, g, d)
    dv = torch.einsum("bkgsl,bskgd->blkd", p.to(do.dtype).to(acc),
                      dog.to(acc))
    dk = torch.einsum("bkgsl,bskgd->blkd", ds.to(q.dtype).to(acc),
                      qg.to(acc))
    dq = torch.einsum("bkgsl,blkd->bskgd", ds.to(k.dtype).to(acc),
                      k.to(acc)).reshape(b, s, h, d)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# the f32 kernels' tiles (csrc/flash_gqa_bwd_f32.cu, csrc/flash_gqa_f32.cu):
# a dk/dv block owns DKDV_F32_KEYS keys and walks the folded rows
# DKDV_F32_ROWS at a time; a dq block owns DQ_F32_ROWS folded rows and
# walks the keys DQ_F32_KEYS at a time, and so does a forward block, in
# one of two tiles (rows: keys, `fwd_f32_tile`), the wide one
# (FWD_F32_ROWS x FWD_F32_KEYS) by default
DKDV_F32_ROWS = 32
DKDV_F32_KEYS = 64
DQ_F32_ROWS = 64
DQ_F32_KEYS = 32
FWD_F32_TILES = {64: 32, 32: 64}
FWD_F32_ROWS = 64
FWD_F32_KEYS = FWD_F32_TILES[FWD_F32_ROWS]
# lse above it: p = exp(-1e30 - lse) is exactly +0 in f32
_LSE_NONE = -1e29


def fwd_tile_walked(frontier, qpos, none, key_valid, k0, causal: bool):
    """Whether the f32 kernels walk a (row tile, key tile) pair: the skip
    rule of the forward (`none`: the rows without a visible valid key)
    and, through `dkdv_tile_walked`, of the backward, batched over any
    leading dims.

    frontier, qpos, none (..., R): the tile's rows (F, key position, and
    whether the row has no visible valid key at all; F = 0 for rows past
    S * G); key_valid (..., BK) bool: the block's keys, the first of them
    at k0 (int or (...)). A row keeps the tile when its F passes k0 and
    it sees a valid key of the block (causal: one at or before qpos) or
    has no visible valid key (then every key below F has logit -1e30 and
    weight 1: O is the mean of V over them). Any other row's pairs in
    the block have logit -1e30 or lie past F: before the row's first
    visible valid key, alpha = exp(-1e30 - m) = 0 erases them, after it
    they add exp(-1e30 - m) = +0; so a tile without a keeping row changes
    neither O nor lse."""
    k0 = torch.as_tensor(k0, device=frontier.device)
    if causal:
        keys = k0[..., None] + torch.arange(key_valid.shape[-1],
                                            device=frontier.device)
        first = torch.where(key_valid, keys, torch.iinfo(torch.int64).max)
        sees = first.amin(-1)[..., None] <= qpos
    else:
        sees = key_valid.any(-1)[..., None]
    keep = (frontier > k0[..., None]) & (sees | none)
    return keep.any(-1)


def dkdv_tile_walked(frontier, qpos, lse, key_valid, k0, causal: bool):
    """Whether the f32 backward kernels walk a (row tile, key tile) pair
    (dk/dv walks a key block's row tiles, dq a row block's key tiles):
    `fwd_tile_walked` with lse <= -1e29 marking the rows without a
    visible valid key (p = 1 on their scanned keys). Any other row's
    pairs in a skipped tile have p = 0 (past F) or exp(-1e30 - lse) = +0,
    so such a tile adds nothing to dk, dv or dq."""
    return fwd_tile_walked(frontier, qpos, lse <= _LSE_NONE, key_valid, k0,
                           causal)


def no_visible_key(s: int, lk: int, causal: bool,
                   kv_valid: torch.Tensor) -> torch.Tensor:
    """(B, S) bool: the query positions that see no valid key of
    kv_valid (B, Lk), whose rows return the mean of V over their scanned
    keys (lse ~ -1e30): causal, the batch's first valid key lies past the
    position; not causal, the batch has no valid key."""
    valid = kv_valid.to(torch.bool)
    dev = valid.device
    first = torch.where(valid.any(-1), valid.to(torch.int32).argmax(-1), lk)
    qpos = ((lk - s) + torch.arange(s, device=dev) if causal
            else torch.full((s,), lk - 1, device=dev))
    return first[:, None] > qpos[None, :]


def _walk_map(s, lk, g, causal, kv_valid, none, rows, keys):
    """(B, KVH, Lk / keys, ceil(S * G / rows)) bool: the pairs of a
    `rows`-row tile and a `keys`-key tile that `fwd_tile_walked` keeps,
    for none (B, KVH, S * G) bool (the rows without a visible valid
    key)."""
    b, kvh, nrows = none.shape
    dev = none.device
    nt = -(-nrows // rows)
    r = torch.arange(nt * rows, device=dev)
    qi = torch.clamp(r // g, max=s - 1)
    live = r < nrows
    f = torch.where(live, row_frontier(s, lk, g, causal, dev)[qi], 0)
    qpos = (lk - s if causal else 0) + qi
    pad = torch.zeros((b, kvh, nt * rows - nrows), dtype=torch.bool,
                      device=dev)
    none_t = torch.cat([none, pad], -1).reshape(b, kvh, 1, nt, rows)
    if kv_valid is None:
        kv_valid = torch.ones((b, lk), dtype=torch.bool, device=dev)
    nkb = lk // keys
    valid = kv_valid.to(device=dev, dtype=torch.bool).reshape(
        b, 1, nkb, 1, keys)
    k0 = (torch.arange(nkb, device=dev) * keys)[:, None]
    return fwd_tile_walked(f.reshape(nt, rows), qpos.reshape(nt, rows),
                           none_t, valid, k0, causal)


def dkdv_walk_map(s: int, lk: int, g: int, causal: bool,
                  kv_valid: Optional[torch.Tensor], lse: torch.Tensor, *,
                  rows: int = DKDV_F32_ROWS,
                  keys: int = DKDV_F32_KEYS) -> torch.Tensor:
    """(B, KVH, Lk / keys, ceil(S * G / rows)) bool: the pairs of a
    `rows`-row tile and a `keys`-key tile that the skip rule keeps
    (`dkdv_tile_walked`), for lse (B, KVH, S * G); by default in the f32
    dk/dv kernel's tiles, the row tiles each key block walks."""
    return _walk_map(s, lk, g, causal, kv_valid, lse <= _LSE_NONE, rows,
                     keys)


def dq_walk_map(s: int, lk: int, g: int, causal: bool,
                kv_valid: Optional[torch.Tensor],
                lse: torch.Tensor) -> torch.Tensor:
    """(B, KVH, ceil(S * G / DQ_F32_ROWS), Lk / DQ_F32_KEYS) bool: the key
    tiles each row block of the f32 dq kernel walks, by the same rule
    (`dkdv_tile_walked`) in its tiles."""
    return dkdv_walk_map(s, lk, g, causal, kv_valid, lse, rows=DQ_F32_ROWS,
                         keys=DQ_F32_KEYS).transpose(-1, -2).contiguous()


def fwd_walk_map(s: int, lk: int, g: int, kvh: int, causal: bool,
                 kv_valid: torch.Tensor, *, rows: int = FWD_F32_ROWS,
                 keys: Optional[int] = None) -> torch.Tensor:
    """(B, KVH, ceil(S * G / rows), Lk / keys) bool: the key tiles each
    row block of the f32 forward walks for kv_valid (B, Lk)
    (`fwd_tile_walked`, the rows without a visible valid key from
    `no_visible_key`) in tiles of `rows` folded rows (keys:
    FWD_F32_TILES[rows] by default). With the forward's lse it is the
    backward's map in the same tiles."""
    keys = keys or FWD_F32_TILES[rows]
    b = kv_valid.shape[0]
    none = no_visible_key(s, lk, causal, kv_valid)              # (B, S)
    none = none.repeat_interleave(g, -1)[:, None].expand(b, kvh, s * g)
    return _walk_map(s, lk, g, causal, kv_valid, none, rows,
                     keys).transpose(-1, -2).contiguous()


_FWD_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_float]


def _lib():
    from wedetect_tpu_torch.ops import _build

    lib = _build.load("flash_attn")
    if not getattr(lib, "_typed_gqa", False):
        lib.gqa_flash_fwd.argtypes = _FWD_ARGS + [ctypes.c_int,
                                                  ctypes.c_void_p]
        lib.gqa_flash_fwd.restype = ctypes.c_int
        lib._typed_gqa = True
    return lib


def _sm90_lib():
    from wedetect_tpu_torch.ops import _build

    lib = _build.load("flash_gqa_sm90")
    if not getattr(lib, "_typed", False):
        lib.gqa_flash_fwd_sm90.argtypes = _FWD_ARGS + [ctypes.c_void_p]
        lib.gqa_flash_fwd_sm90.restype = ctypes.c_int
        lib._typed = True
    return lib


def _bwd_lib():
    from wedetect_tpu_torch.ops import _build

    lib = _build.load("flash_attn_bwd")
    if not getattr(lib, "_typed_gqa", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.gqa_flash_bwd_dq.argtypes = [p] * 8 + [i] * 9 + [f, i, p]
        lib.gqa_flash_bwd_dkdv.argtypes = [p] * 9 + [i] * 9 + [f, i, p]
        lib.gqa_flash_bwd_dq.restype = ctypes.c_int
        lib.gqa_flash_bwd_dkdv.restype = ctypes.c_int
        lib._typed_gqa = True
    return lib


def _bwd_sm90_lib():
    from wedetect_tpu_torch.ops import _build

    lib = _build.load("flash_gqa_bwd_sm90")
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.gqa_flash_bwd_dq_sm90.argtypes = [p] * 8 + [i] * 9 + [f, p]
        lib.gqa_flash_bwd_dkdv_sm90.argtypes = [p] * 9 + [i] * 9 + [f, p]
        lib.gqa_flash_bwd_dq_sm90.restype = ctypes.c_int
        lib.gqa_flash_bwd_dkdv_sm90.restype = ctypes.c_int
        lib._typed = True
    return lib


def type_bwd_f32(lib):
    """Set the C signatures of csrc/flash_gqa_bwd_f32.cu's entries on a
    loaded library (also a variant build's); returns it."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.gqa_flash_bwd_dkdv_f32.argtypes = [p] * 9 + [i] * 9 + [f, p, p]
    lib.gqa_flash_bwd_dq_f32.argtypes = [p] * 8 + [i] * 9 + [f, p, p]
    lib.gqa_flash_bwd_dkdv_f32.restype = ctypes.c_int
    lib.gqa_flash_bwd_dq_f32.restype = ctypes.c_int
    lib._typed = True
    return lib


def _bwd_f32_lib():
    from wedetect_tpu_torch.ops import _build

    lib = _build.load("flash_gqa_bwd_f32")
    return lib if getattr(lib, "_typed", False) else type_bwd_f32(lib)


def _check_cuda(name, q, k, v, others=()):
    """The kernels' input rules: dtype, device, shapes, contiguity."""
    b, s, h, d = q.shape
    lk, kvh = k.shape[1], k.shape[2]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: dtype {q.dtype} (float32 or bfloat16 "
                        "only)")
    for tname, t, shape in (("k", k, (b, lk, kvh, d)),
                            ("v", v, (b, lk, kvh, d)), *others):
        if t.dtype != q.dtype or t.device != q.device:
            raise TypeError(f"{name}: {tname} must match q's dtype and "
                            "device")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {tname} shape {tuple(t.shape)}, "
                             f"want {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous")
    if not q.is_contiguous():
        raise ValueError(f"{name}: q must be contiguous")
    if d not in SIMT_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d}: the CUDA kernels take "
                         f"{', '.join(map(str, SIMT_HEAD_DIMS))}, at most "
                         f"{SIMT_HEAD_DIMS[-1]}")


def _valid_i32(kv_valid, b, lk, device, name):
    if kv_valid is None:
        return torch.ones((b, lk), dtype=torch.int32, device=device)
    if tuple(kv_valid.shape) != (b, lk):
        raise ValueError(f"{name}: kv_valid shape {tuple(kv_valid.shape)}, "
                         f"want {(b, lk)}")
    return kv_valid.to(device=device, dtype=torch.int32).contiguous()


def _route(name, dtype, d, rows, g):
    if dtype == torch.float32:
        return "simt"
    if dtype != torch.bfloat16:
        raise TypeError(f"{name}: dtype {dtype} (float32 or bfloat16 only)")
    return "sm90" if d == 128 and rows % g == 0 else "simt"


def fwd_route(dtype: torch.dtype, d: int, g: int) -> str:
    """The K2 forward kernel a CUDA input takes: "f32"
    (csrc/flash_gqa_f32.cu, FFMA register tiles fed by cp.async) for f32
    at D = 128; "sm90" (csrc/flash_gqa_sm90.cu, wgmma + TMA) for bf16 at
    D = 128 with G dividing 128 (its 128-row Q box); "simt"
    (csrc/flash_attn.cu) for f32 at D = 256, 384 or 512 and for any other
    bf16 shape. Raises TypeError for other types."""
    if dtype == torch.float32 and d == 128:
        return "f32"
    return _route("gqa_flash_attention", dtype, d, 128, g)


def bwd_route(dtype: torch.dtype, d: int, g: int) -> str:
    """The K2 backward kernels' route outside f32 at D = 128 (`dq_route`,
    `dkdv_route`): "sm90" (csrc/flash_gqa_bwd_sm90.cu, wgmma + TMA) for
    bf16 at D = 128 with G dividing 64 (the dk/dv kernel's 64-row Q and
    dO boxes); "simt" (csrc/flash_attn_bwd.cu) for f32 and for any other
    bf16 shape (D = 256). Raises for other types."""
    return _route("gqa_flash_attention_bwd", dtype, d, 64, g)


def dkdv_route(dtype: torch.dtype, d: int, g: int) -> str:
    """The K2-bwd-dkdv kernel a CUDA input takes: "f32"
    (csrc/flash_gqa_bwd_f32.cu, FFMA register tiles fed by cp.async) for
    f32 at D = 128; "sm90" (csrc/flash_gqa_bwd_sm90.cu) for bf16 at
    D = 128 with G dividing 64, as `bwd_route`; "simt"
    (csrc/flash_attn_bwd.cu) for everything else (f32 or bf16 at D = 64
    or 256, other bf16 group sizes). K2-bwd-dq goes the same way
    (`dq_route`). Raises TypeError for other types."""
    if dtype == torch.float32 and d == 128:
        return "f32"
    return bwd_route(dtype, d, g)


def dq_route(dtype: torch.dtype, d: int, g: int) -> str:
    """The K2-bwd-dq kernel a CUDA input takes: "f32"
    (csrc/flash_gqa_bwd_f32.cu:gqa_flash_bwd_dq_f32, FFMA register tiles
    fed by cp.async) for f32 at D = 128; `bwd_route`'s answer otherwise
    ("sm90" for bf16 at D = 128 with G dividing 64, else "simt"). Raises
    TypeError for other types."""
    return dkdv_route(dtype, d, g)


def _launch_fwd(name, fn, q, k, v, kv_valid, causal, sm_scale, *tail):
    """Allocate O and lse and launch one K2 forward kernel `fn`."""
    b, s, h, d = q.shape
    lk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    valid = _valid_i32(kv_valid, b, lk, q.device, name)
    o = torch.empty_like(q)
    lse = torch.empty((b, kvh, s * g), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
                 o.data_ptr(), lse.data_ptr(), b, s, lk, h, kvh, d,
                 int(causal), _pick_bq(s, g), _pick_bk(lk), float(sm_scale),
                 *tail, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    return o, lse


def _check_aligned(name, *named):
    """TMA (or cp.async) copies q, k, v (and dO, dk, dv) in 16-byte
    pieces in place: each must be 16-byte aligned."""
    for tname, t in named:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {tname} must be 16-byte aligned "
                             "(TMA / cp.async copy 16-byte pieces)")


def gqa_flash_fwd_sm90(q, k, v, kv_valid, causal, sm_scale):
    """One launch of K2's bf16 kernel (wgmma + TMA): (O, lse), on inputs
    that `_check_cuda` and `fwd_route` passed."""
    _check_aligned("gqa_flash_attention", ("q", q), ("k", k), ("v", v))
    out = _launch_fwd("gqa_flash_attention", _sm90_lib().gqa_flash_fwd_sm90,
                      q, k, v, kv_valid, causal, sm_scale)
    gqa_flash_fwd_sm90.launches += 1
    return out


gqa_flash_fwd_sm90.launches = 0


def type_fwd_f32(lib):
    """Set the C signatures of csrc/flash_gqa_f32.cu's entries on a loaded
    library (also a variant build's); returns it."""
    lib.gqa_flash_fwd_f32.argtypes = _FWD_ARGS + [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.gqa_flash_fwd_f32.restype = ctypes.c_int
    lib.gqa_flash_fwd_f32_keys.argtypes = [ctypes.c_int]
    lib.gqa_flash_fwd_f32_keys.restype = ctypes.c_int
    lib._typed = True
    return lib


def fwd_f32_tile(b: int, s: int, g: int, kvh: int, sms: int):
    """(rows, keys): the f32 forward's tile for B x KVH x S * G folded
    rows on a card of `sms` SMs (one block an SM): the wide tile, 64
    rows x 32 keys, when its grid fills the card, else the narrow one,
    32 x 64 (twice the blocks). At the Ref prefix (96 wide blocks on 132
    SMs) the narrow tile took 0.032 ms against the wide one's 0.050, and
    24-25% longer than it on the full grids of the suffix and K2_TRAIN
    (PERF.md §6, tools/time_k2.py --variant)."""
    rows = 64 if b * kvh * -(-s * g // 64) >= sms else 32
    return rows, FWD_F32_TILES[rows]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _fwd_f32_lib():
    from wedetect_tpu_torch.ops import _build

    lib = _build.load("flash_gqa_f32")
    return lib if getattr(lib, "_typed", False) else type_fwd_f32(lib)


def gqa_flash_fwd_f32(q, k, v, kv_valid, causal, sm_scale, walked=None,
                      rows=None):
    """One launch of K2's f32 kernel (FFMA register tiles fed by cp.async,
    D = 128): (O, lse), on inputs that `_check_cuda` passed. `rows`: the
    tile's folded rows (64 or 32); by default `fwd_f32_tile`'s for the
    card. `walked`: None, or a contiguous int32 CUDA tensor
    (B, KVH, ceil(S * G / rows)) that gets each row block's count of
    walked key tiles (`fwd_walk_map` counts the same). Raises for
    another type or head dim, and for a q, k or v that is not 16-byte
    aligned (cp.async copies 16 bytes)."""
    name = "gqa_flash_attention"
    b, s, h, _ = q.shape
    kvh = k.shape[2]
    if rows is None:
        rows, _ = fwd_f32_tile(b, s, h // kvh, kvh,
                               _sm_count(q.device.index or 0))
    if q.dtype != torch.float32:
        raise TypeError(f"{name}: the f32 kernel takes float32, got "
                        f"{q.dtype}")
    if q.shape[3] != 128:
        raise ValueError(f"{name}: the f32 kernel takes head dim 128, got "
                         f"{q.shape[3]}")
    _check_aligned(name, ("q", q), ("k", k), ("v", v))
    if walked is not None:
        want = (b, kvh, -(-s * (h // kvh) // rows))
        if walked.dtype != torch.int32 or tuple(walked.shape) != want \
                or walked.device != q.device or not walked.is_contiguous():
            raise ValueError(f"{name}: walked must be contiguous int32 "
                             f"{want} on q's device")
    out = _launch_fwd(name, _fwd_f32_lib().gqa_flash_fwd_f32, q, k, v,
                      kv_valid, causal, sm_scale, rows,
                      None if walked is None else walked.data_ptr())
    gqa_flash_fwd_f32.launches += 1
    return out


gqa_flash_fwd_f32.launches = 0


def _fwd_kernel(q, k, v, kv_valid, causal, sm_scale):
    """One launch of K2, by type and shape (`fwd_route`): (O, lse)."""
    name = "gqa_flash_attention"
    _check_cuda(name, q, k, v)
    route = fwd_route(q.dtype, q.shape[3], q.shape[2] // k.shape[2])
    if route == "sm90":
        out = gqa_flash_fwd_sm90(q, k, v, kv_valid, causal, sm_scale)
    elif route == "f32":
        out = gqa_flash_fwd_f32(q, k, v, kv_valid, causal, sm_scale)
    else:
        out = _launch_fwd(name, _lib().gqa_flash_fwd, q, k, v, kv_valid,
                          causal, sm_scale, int(q.dtype == torch.bfloat16))
    gqa_flash_attention.launches += 1
    return out


def _forward(q, k, v, kv_valid, causal, sm_scale):
    if q.device.type == "cpu":
        return gqa_flash_attention_plain(q, k, v, causal=causal,
                                         kv_valid=kv_valid,
                                         sm_scale=sm_scale, return_lse=True)
    if q.device.type != "cuda":
        raise ValueError(f"gqa_flash_attention: unsupported device "
                         f"{q.device}")
    return _fwd_kernel(q, k, v, kv_valid, causal, sm_scale)


def _check_bwd(name, q, k, v, kv_valid, do, lse, delta):
    """The backward kernels' input rules; returns kv_valid as int32."""
    b, s, h, d = q.shape
    lk, kvh = k.shape[1], k.shape[2]
    _check_cuda(name, q, k, v, (("do", do, (b, s, h, d)),))
    rows = (b, kvh, s * (h // kvh))
    for tname, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or tuple(t.shape) != rows \
                or not t.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous f32 "
                             f"{rows}")
    return _valid_i32(kv_valid, b, lk, q.device, name)


def _launch_bwd(name, fn, q, k, v, valid, do, lse, delta, outs, causal,
                sm_scale, *tail):
    """Launch one K2 backward kernel `fn` writing `outs`."""
    b, s, h, d = q.shape
    lk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 *(t.data_ptr() for t in outs), b, s, lk, h, kvh, d,
                 int(causal), _pick_bq(s, g), _pick_bk(lk), float(sm_scale),
                 *tail, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def _bwd_sm90(name, q, k, v, do):
    """Whether bf16 input takes the wgmma kernels (`bwd_route`); they
    read q, k, v and dO through TMA, which needs each 16-byte aligned."""
    if bwd_route(q.dtype, q.shape[3], q.shape[2] // k.shape[2]) != "sm90":
        return False
    _check_aligned(name, ("q", q), ("k", k), ("v", v), ("do", do))
    return True


def gqa_flash_bwd_dq_sm90(q, k, v, valid, do, lse, delta, dq, *, causal,
                          sm_scale):
    """One launch of K2-bwd-dq's bf16 kernel (wgmma + TMA) into dq, on
    inputs that `_check_bwd` and `_bwd_sm90` passed."""
    _launch_bwd("gqa_flash_bwd_dq", _bwd_sm90_lib().gqa_flash_bwd_dq_sm90,
                q, k, v, valid, do, lse, delta, (dq,), causal, sm_scale)
    gqa_flash_bwd_dq_sm90.launches += 1


def gqa_flash_bwd_dkdv_sm90(q, k, v, valid, do, lse, delta, dk, dv, *,
                            causal, sm_scale):
    """One launch of K2-bwd-dkdv's bf16 kernel (wgmma + TMA) into dk and
    dv, on inputs that `_check_bwd` and `_bwd_sm90` passed."""
    _launch_bwd("gqa_flash_bwd_dkdv",
                _bwd_sm90_lib().gqa_flash_bwd_dkdv_sm90, q, k, v, valid, do,
                lse, delta, (dk, dv), causal, sm_scale)
    gqa_flash_bwd_dkdv_sm90.launches += 1


def gqa_flash_bwd_dkdv_f32(q, k, v, valid, do, lse, delta, dk, dv, *,
                           causal, sm_scale, walked=None):
    """One launch of K2-bwd-dkdv's f32 kernel (FFMA register tiles fed by
    cp.async, D = 128) into dk and dv, on inputs that `_check_bwd`
    passed. `walked`: None, or a contiguous int32 CUDA tensor
    (B, KVH, Lk / DKDV_F32_KEYS) that gets each key block's count of
    walked row tiles (`dkdv_walk_map` counts the same). Raises for
    another type or head dim, and for a q, k, v, dO, dk or dv that is not
    16-byte aligned (cp.async copies 16 bytes)."""
    name = "gqa_flash_bwd_dkdv"
    if q.dtype != torch.float32 or dk.dtype != torch.float32 \
            or dv.dtype != torch.float32:
        raise TypeError(f"{name}: the f32 kernel takes float32, got "
                        f"{q.dtype}")
    if q.shape[3] != 128:
        raise ValueError(f"{name}: the f32 kernel takes head dim 128, got "
                         f"{q.shape[3]}")
    _check_aligned(name, ("q", q), ("k", k), ("v", v), ("do", do),
                   ("dk", dk), ("dv", dv))
    if walked is not None:
        want = (q.shape[0], k.shape[2], k.shape[1] // DKDV_F32_KEYS)
        _check_walked(name, walked, want, q)
    _launch_bwd(name, _bwd_f32_lib().gqa_flash_bwd_dkdv_f32, q, k, v, valid,
                do, lse, delta, (dk, dv), causal, sm_scale,
                None if walked is None else walked.data_ptr())
    gqa_flash_bwd_dkdv_f32.launches += 1


def _check_walked(name, walked, want, q):
    if walked.dtype != torch.int32 or tuple(walked.shape) != want \
            or walked.device != q.device or not walked.is_contiguous():
        raise ValueError(f"{name}: walked must be contiguous int32 "
                         f"{want} on q's device")


def gqa_flash_bwd_dq_f32(q, k, v, valid, do, lse, delta, dq, *, causal,
                         sm_scale, walked=None):
    """One launch of K2-bwd-dq's f32 kernel (FFMA register tiles fed by
    cp.async, D = 128) into dq, on inputs that `_check_bwd` passed.
    `walked`: None, or a contiguous int32 CUDA tensor
    (B, KVH, ceil(S * G / DQ_F32_ROWS)) that gets each row block's count
    of walked key tiles (`dq_walk_map` counts the same). Raises for
    another type or head dim, and for a q, k, v, dO or dq that is not
    16-byte aligned (cp.async copies 16 bytes)."""
    name = "gqa_flash_bwd_dq"
    if q.dtype != torch.float32 or dq.dtype != torch.float32:
        raise TypeError(f"{name}: the f32 kernel takes float32, got "
                        f"{q.dtype}")
    if q.shape[3] != 128:
        raise ValueError(f"{name}: the f32 kernel takes head dim 128, got "
                         f"{q.shape[3]}")
    _check_aligned(name, ("q", q), ("k", k), ("v", v), ("do", do),
                   ("dq", dq))
    if walked is not None:
        b, s, h, _ = q.shape
        kvh = k.shape[2]
        _check_walked(name, walked,
                      (b, kvh, -(-s * (h // kvh) // DQ_F32_ROWS)), q)
    _launch_bwd(name, _bwd_f32_lib().gqa_flash_bwd_dq_f32, q, k, v, valid,
                do, lse, delta, (dq,), causal, sm_scale,
                None if walked is None else walked.data_ptr())
    gqa_flash_bwd_dq_f32.launches += 1


gqa_flash_bwd_dq_sm90.launches = 0
gqa_flash_bwd_dkdv_sm90.launches = 0
gqa_flash_bwd_dkdv_f32.launches = 0
gqa_flash_bwd_dq_f32.launches = 0


def gqa_flash_bwd_dq(q, k, v, kv_valid, do, lse, delta, *, causal,
                     sm_scale):
    """One launch of K2-bwd-dq on CUDA tensors: dq (B, S, H, D). lse and
    delta (B, KVH, S * G) f32 (`row_delta`). The kernel goes by
    `dq_route`; every launch is counted here, the f32 kernel's also in
    `gqa_flash_bwd_dq_f32.launches`, the bf16 wgmma kernel's in
    `gqa_flash_bwd_dq_sm90.launches`."""
    name = "gqa_flash_bwd_dq"
    valid = _check_bwd(name, q, k, v, kv_valid, do, lse, delta)
    dq = torch.empty_like(q)
    kw = dict(causal=causal, sm_scale=sm_scale)
    if dq_route(q.dtype, q.shape[3], q.shape[2] // k.shape[2]) == "f32":
        gqa_flash_bwd_dq_f32(q, k, v, valid, do, lse, delta, dq, **kw)
    elif _bwd_sm90(name, q, k, v, do):
        gqa_flash_bwd_dq_sm90(q, k, v, valid, do, lse, delta, dq, **kw)
    else:
        _launch_bwd(name, _bwd_lib().gqa_flash_bwd_dq, q, k, v, valid, do,
                    lse, delta, (dq,), causal, sm_scale,
                    int(q.dtype == torch.bfloat16))
    gqa_flash_bwd_dq.launches += 1
    return dq


def gqa_flash_bwd_dkdv(q, k, v, kv_valid, do, lse, delta, *, causal,
                       sm_scale):
    """One launch of K2-bwd-dkdv on CUDA tensors: (dk, dv), each
    (B, Lk, KVH, D). The kernel goes by `dkdv_route`; every launch is
    counted here, the f32 kernel's also in
    `gqa_flash_bwd_dkdv_f32.launches`, the bf16 wgmma kernel's in
    `gqa_flash_bwd_dkdv_sm90.launches`."""
    name = "gqa_flash_bwd_dkdv"
    valid = _check_bwd(name, q, k, v, kv_valid, do, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    route = dkdv_route(q.dtype, q.shape[3], q.shape[2] // k.shape[2])
    kw = dict(causal=causal, sm_scale=sm_scale)
    if route == "f32":
        gqa_flash_bwd_dkdv_f32(q, k, v, valid, do, lse, delta, dk, dv, **kw)
    elif _bwd_sm90(name, q, k, v, do):
        gqa_flash_bwd_dkdv_sm90(q, k, v, valid, do, lse, delta, dk, dv,
                                **kw)
    else:
        _launch_bwd(name, _bwd_lib().gqa_flash_bwd_dkdv, q, k, v, valid, do,
                    lse, delta, (dk, dv), causal, sm_scale,
                    int(q.dtype == torch.bfloat16))
    gqa_flash_bwd_dkdv.launches += 1
    return dk, dv


gqa_flash_bwd_dq.launches = 0
gqa_flash_bwd_dkdv.launches = 0


def gqa_flash_attention_bwd(q, k, v, kv_valid, o, lse, do, *, causal,
                            sm_scale):
    """(dq, dk, dv) of gqa_flash_attention from the saved O and lse.
    CUDA tensors: K2-bwd-dq and K2-bwd-dkdv, one launch each; CPU
    tensors: the plain version."""
    if q.device.type == "cpu":
        return gqa_flash_attention_bwd_plain(q, k, v, kv_valid, o, lse, do,
                                             causal, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"gqa_flash_attention_bwd: unsupported device "
                         f"{q.device}")
    delta = row_delta(o, do, k.shape[2])
    kw = dict(causal=causal, sm_scale=sm_scale)
    dq = gqa_flash_bwd_dq(q, k, v, kv_valid, do, lse, delta, **kw)
    dk, dv = gqa_flash_bwd_dkdv(q, k, v, kv_valid, do, lse, delta, **kw)
    return dq, dk, dv


class _GqaFlash(torch.autograd.Function):
    """K2 with its backward: saves q, k, v, kv_valid, O and lse (never an
    S x Lk matrix)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_valid, causal, sm_scale):
        o, lse = _forward(q, k, v, kv_valid, causal, sm_scale)
        ctx.save_for_backward(q, k, v, kv_valid, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, kv_valid, o, lse = ctx.saved_tensors
        dq, dk, dv = gqa_flash_attention_bwd(
            q, k, v, kv_valid, o, lse, do.contiguous(), causal=ctx.causal,
            sm_scale=ctx.sm_scale)
        return dq, dk, dv, None, None, None


def gqa_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        kv_valid: Optional[torch.Tensor] = None,
                        sm_scale: Optional[float] = None,
                        return_lse: bool = False):
    """(B, S, H, D) x (B, Lk, KVH, D) -> (B, S, H, D) [, lse].

    CUDA tensors: one launch of a CUDA kernel (`fwd_route`), counted in
    `gqa_flash_attention.launches` (the wgmma kernel's also in
    `gqa_flash_fwd_sm90.launches`, the f32 FFMA kernel's in
    `gqa_flash_fwd_f32.launches`). CPU tensors: the plain version.
    Differentiable in q, k and v (module docstring).
    """
    _check(q, k, v, causal)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    args = (q, k, v, kv_valid, causal, float(sm_scale))
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        o, lse = _GqaFlash.apply(*args)
    else:       # no graph to record: skip the autograd Function's cost
        o, lse = _forward(*args)
    return (o, lse) if return_lse else o


gqa_flash_attention.launches = 0
