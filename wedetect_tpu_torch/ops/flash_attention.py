"""Square flash attention forward with segment ids: kernel K3 of the port.

Replaces the stock Pallas TPU `flash_attention`
(`jax.experimental.pallas.ops.tpu.flash_attention`) that
`wedetect_tpu/ops/attention.py:_flash_attention` calls; the Qwen3-VL
ViT reaches it once per block through `dot_product_attention`, with the
token axis padded to a multiple of 128 and the pad tokens in segment 0.

Contract (`flash_attention_plain`, and the kernel on the card):
q, k, v (B, L, H, D) -- the layout `_flash_attention` receives, read in
place; optional segment ids (B, L) for the queries and the keys. Logits
q.k * sm_scale in f32; a key whose segment differs from the query's has
logit -1e30; with `causal`, keys after the query are absent (weight 0).
f32 softmax, O in the input dtype; with `return_lse` also the per-row
logsumexp (B, H, L) f32. As in the stock kernel, a pad query row attends
the pad keys only, so it differs from the einsum reference
(`_reference_attention`, which masks pad keys for every row) on pad rows
and agrees on real rows; callers discard pad rows.

`flash_attention` launches K3 on CUDA tensors and runs the plain version
on CPU tensors; there is no fallback. The kernel goes by `fwd_route`:
at D = 64 (the ViT's) bf16 takes the wgmma + TMA kernel of
`csrc/flash_attn_sm90.cu` and f32 the FFMA kernel of
`csrc/flash_attn_f32.cu` (register tiles fed by a cp.async ring, walking
only the key tiles that can change O: `fwd_tile_walked`,
`fwd_walk_map`); every other head dim takes the SIMT template of
`csrc/flash_attn.cu:flash_attention_fwd`. It is differentiable
in q, k and v (a `torch.autograd.Function`, the stock kernel's custom
VJP): the forward saves q, k, v, the segment ids, O and lse, and the
backward (`flash_attention_bwd`) launches kernels K3-bwd-dq and
K3-bwd-dkv (the stock `_flash_attention_bwd_dq` and
`_flash_attention_bwd_dkv`) on CUDA tensors and runs
`flash_attention_bwd_plain` on CPU tensors. The backward kernels go by
`bwd_route`: bf16 at D = 64 (the ViT's) takes the wgmma + TMA pair of
`csrc/flash_attn_bwd_sm90.cu`, f32 and the other bf16 head dims the SIMT
pair of `csrc/flash_attn_bwd.cu`; dk/dv goes by `dkv_route` and dq by
`dq_route`, which also send f32 at D = 64 to the FFMA kernels of
`csrc/flash_attn_bwd_f32.cu` (register tiles fed by a cp.async ring,
each walking only the tiles that can change its gradient:
`dkv_tile_walked`, `dkv_walk_map`, `dq_walk_map`). A CUDA input that its
kernel cannot take raises. p is recomputed as exp(s - lse) from the saved
logsumexp (the stock kernels keep m and l apart: the same p up to
rounding); di = rowsum(dO * O) is plain torch, as in the stock VJP.

Head dims on the card. The SIMT kernels are built for D = 64, 128, 256,
384 and 512 (`SIMT_HEAD_DIMS`); any other D up to 512 is zero-padded to
the next of them (`simt_head_dim`, `pad_head_dim`) and O, dq, dk and dv
are sliced back. Zero columns change no logit and no real output
column, and sm_scale stays the caller's. Above 512 a CUDA input raises
before any launch: a deliberate difference from the stock Pallas kernel,
which takes any D. CPU tensors take any D.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

_NEG = -1e30
# the head dims the SIMT kernels are built for (csrc/flash_attn.cu,
# csrc/flash_attn_bwd.cu); the largest is the card's limit
SIMT_HEAD_DIMS = (64, 128, 256, 384, 512)


def _check(q, k, v, q_segment_ids, kv_segment_ids):
    if q.dim() != 4 or tuple(k.shape) != tuple(q.shape) \
            or tuple(v.shape) != tuple(q.shape):
        raise ValueError("flash_attention: q, k, v must share one "
                         f"(B, L, H, D) shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("flash_attention: give both segment ids or none")
    if q_segment_ids is not None:
        b, l = q.shape[:2]
        for t in (q_segment_ids, kv_segment_ids):
            if tuple(t.shape) != (b, l):
                raise ValueError(f"flash_attention: segment ids shape "
                                 f"{tuple(t.shape)}, want {(b, l)}")


def _acc_dtype(q):
    """The plain versions' accumulation type: f32, or f64 for f64
    inputs (gradcheck)."""
    return torch.float64 if q.dtype == torch.float64 else torch.float32


def _masked_logits(q, k, q_segment_ids, kv_segment_ids, causal, sm_scale):
    """(B, H, L, L) f32 logits: -1e30 across segments, -inf after the
    query when causal."""
    acc = _acc_dtype(q)
    l = q.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(acc),
                          k.to(acc)) * sm_scale
    if q_segment_ids is not None:
        same = q_segment_ids[:, :, None] == kv_segment_ids[:, None, :]
        logits = torch.where(same[:, None], logits, _NEG)
    if causal:
        later = torch.ones((l, l), dtype=torch.bool,
                           device=q.device).triu(1)
        logits = logits.masked_fill(later, float("-inf"))
    return logits


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, q_segment_ids: Optional[torch.Tensor] = None,
                          kv_segment_ids: Optional[torch.Tensor] = None,
                          causal: bool = False, sm_scale: float = 1.0,
                          return_lse: bool = False):
    """The kernel's function in plain PyTorch (module docstring)."""
    _check(q, k, v, q_segment_ids, kv_segment_ids)
    logits = _masked_logits(q, k, q_segment_ids, kv_segment_ids, causal,
                            sm_scale)
    o, lse = fwd_plain_from_logits(logits, v, q.dtype)
    return (o, lse) if return_lse else o


def fwd_plain_from_logits(logits: torch.Tensor, v: torch.Tensor,
                          dtype: torch.dtype):
    """The plain forward from its masked logits (B, H, L, L) in the
    accumulation type: (O (B, L, H, D) in `dtype`, lse (B, H, L))."""
    acc = logits.dtype
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    s = p.sum(-1, keepdim=True)                       # (B, H, L, 1)
    # the kernel casts p to V's dtype before the p.V product
    o = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).to(acc),
                     v.to(acc))
    return (o / s).transpose(1, 2).to(dtype), (m + torch.log(s))[..., 0]


def row_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """di = rowsum(dO * O) in f32, (B, H, L) like lse (the stock VJP)."""
    acc = _acc_dtype(o)
    return (do.to(acc) * o.to(acc)).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, q_segment_ids=None,
                              kv_segment_ids=None, causal=False,
                              sm_scale=1.0):
    """The backward kernels' function in plain PyTorch: (dq, dk, dv).

    The stock kernels' formulas (`_flash_attention_dq_kernel`,
    `_flash_attention_dkv_kernel`) with p = exp(s - lse): ds = (dO.V^T -
    di) * p * sm_scale, dv = p^T.dO with p cast to dO's dtype, dk =
    ds^T.Q and dq = ds.K with ds cast to the input dtype; f32 sums."""
    p, ds = bwd_plain_weights(q, k, v, o, lse, do,
                              q_segment_ids=q_segment_ids,
                              kv_segment_ids=kv_segment_ids, causal=causal,
                              sm_scale=sm_scale)
    return bwd_plain_products(q, k, v, do, p, ds)


def bwd_plain_weights(q, k, v, o, lse, do, *, q_segment_ids=None,
                      kv_segment_ids=None, causal=False, sm_scale=1.0):
    """p and ds of the plain backward, each (B, H, L, L) in the
    accumulation type: p = exp(s - lse) (0 past the causal frontier),
    ds = p * (dO.V^T - di) * sm_scale."""
    acc = _acc_dtype(q)
    _check(q, k, v, q_segment_ids, kv_segment_ids)
    logits = _masked_logits(q, k, q_segment_ids, kv_segment_ids, causal,
                            sm_scale)
    p = torch.exp(logits - lse[..., None])            # (B, H, L, L)
    delta = row_delta(o, do)[..., None]
    dp = torch.einsum("bqhd,bkhd->bhqk", do.to(acc), v.to(acc))
    return p, p * (dp - delta) * sm_scale


def bwd_plain_products(q, k, v, do, p, ds):
    """(dq, dk, dv) of the plain backward from its p and ds: dv = p^T.dO
    with p cast to dO's dtype, dk = ds^T.Q and dq = ds.K with ds cast to
    the input dtype; f32 sums."""
    acc = _acc_dtype(q)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).to(acc),
                      do.to(acc))
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).to(acc),
                      q.to(acc))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).to(acc),
                      k.to(acc))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def simt_head_dim(d: int, name: str = "flash_attention") -> int:
    """The width the SIMT kernels run head dim d at: the smallest of
    SIMT_HEAD_DIMS at or above d. Raises ValueError above 512, the
    card's limit (module docstring)."""
    for w in SIMT_HEAD_DIMS:
        if d <= w:
            return w
    raise ValueError(f"{name}: head dim {d}: the CUDA kernels take head "
                     f"dims up to {SIMT_HEAD_DIMS[-1]}")


def pad_head_dim(width: int, *tensors: torch.Tensor):
    """The tensors (..., D), each zero-padded in D to (..., width), as a
    list: the SIMT launches' input at a D they are not built for."""
    return [t if t.shape[-1] == width
            else torch.nn.functional.pad(t, (0, width - t.shape[-1]))
            for t in tensors]


# the f32 kernels' tiles (csrc/flash_attn_bwd_f32.cu, csrc/flash_attn_f32.cu):
# a dk/dv block owns DKV_F32_KEYS keys and walks the rows DKV_F32_ROWS at
# a time; a dq block owns DQ_F32_ROWS rows and walks the keys DQ_F32_KEYS
# at a time, and so does a forward block, in one of two tiles (rows: keys,
# `fwd_f32_tile`), the wide one (FWD_F32_ROWS x FWD_F32_KEYS, the dq
# kernel's) by default
DKV_F32_ROWS = 64
DKV_F32_KEYS = 128
DQ_F32_ROWS = 128
DQ_F32_KEYS = 64
FWD_F32_TILES = {128: 64, 64: 64}
FWD_F32_ROWS = 128
FWD_F32_KEYS = FWD_F32_TILES[FWD_F32_ROWS]
# a narrow (64-row) forward block's time over a wide one's: 2.43 / 2.01 / 2
# at the ViT's training shape (PERF.md §6, tools/time_k3.py --variant)
_NARROW_BLOCK_COST = 0.6
# lse above it: p = exp(-1e30 - lse) is exactly +0 in f32
_LSE_NONE = -1e29


def fwd_tile_walked(qpos, qseg, none, kseg, k0, l: int, causal: bool):
    """Whether the f32 kernels walk a (row tile, key tile) pair: the skip
    rule of the forward (`none`: the rows with no key of their segment
    below their frontier) and, through `dkv_tile_walked`, of the
    backward, batched over any leading dims (broadcast). The forward and
    the dq kernel test a key tile against their row block, the dk/dv
    kernel a row tile against its key block.

    qpos, qseg, none (..., R): the tile's rows (position, segment id, and
    whether the row sees no key of its segment at all); kseg (..., BK):
    the block's keys' segment ids, the first key at k0 (int or (...));
    positions at or past l do not exist. A row keeps the tile when it
    exists, lies at or after k0 under `causal`, and shares its segment
    with a key of the block (under `causal` one at or before it) or is
    `none` (then every key below its frontier has logit -1e30 and weight
    1: O is the mean of V over them). Any other row's pairs in the block
    have logit -1e30 or lie past its frontier: before the row's first
    key of its segment alpha = exp(-1e30 - m) = 0 erases them, after it
    they add exp(-1e30 - m) = +0; so a tile without a keeping row changes
    neither O nor lse."""
    k0 = torch.as_tensor(k0, device=qpos.device)
    keys = k0[..., None] + torch.arange(kseg.shape[-1], device=qpos.device)
    match = (kseg[..., None, :] == qseg[..., :, None]) \
        & (keys < l)[..., None, :]
    if causal:
        match = match & (keys[..., None, :] <= qpos[..., :, None])
    reach = qpos < l
    if causal:
        reach = reach & (qpos >= k0[..., None])
    keep = reach & (match.any(-1) | none)
    return keep.any(-1)


def dkv_tile_walked(qpos, qseg, lse, kseg, k0, l: int, causal: bool):
    """Whether the f32 backward kernels walk a (row tile, key tile) pair
    (the dk/dv kernel tests a row tile against its key block, the dq
    kernel a key tile against its row block): `fwd_tile_walked` with
    lse <= -1e29 marking the rows with no key of their segment below
    their frontier (p = exp(-1e30 - lse) may be nonzero on every such
    key). Any other row's pairs in a skipped tile have p = 0 (past its
    frontier) or exp(-1e30 - lse) = +0, so such a tile adds nothing to
    dq, dk or dv."""
    return fwd_tile_walked(qpos, qseg, lse <= _LSE_NONE, kseg, k0, l,
                           causal)


def _walk_map(l, causal, q_segment_ids, kv_segment_ids, none, rows, keys):
    """(B', H', ceil(L / keys), ceil(L / rows)) bool: the pairs of a
    `rows`-row tile and a `keys`-key tile that `fwd_tile_walked` keeps,
    for none (B', H', L) bool and segment ids (B, L) or None."""
    dev = none.device
    nt, nkb = -(-l // rows), -(-l // keys)

    def tiles(x, n, size, fill):
        """(..., L) -> (..., n, size), padded past L with `fill`."""
        pad = torch.full(x.shape[:-1] + (n * size - l,), fill,
                         dtype=x.dtype, device=dev)
        return torch.cat([x, pad], -1).reshape(*x.shape[:-1], n, size)

    if q_segment_ids is None:
        q_segment_ids = kv_segment_ids = torch.zeros(
            (none.shape[0], l), dtype=torch.int32, device=dev)
    qseg = tiles(q_segment_ids.to(dev, torch.int32), nt, rows, 0)
    kseg = tiles(kv_segment_ids.to(dev, torch.int32), nkb, keys, 0)
    qpos = torch.arange(nt * rows, device=dev).reshape(nt, rows)
    k0 = (torch.arange(nkb, device=dev) * keys)[:, None]
    return fwd_tile_walked(qpos, qseg[:, None, None], tiles(
        none, nt, rows, False)[:, :, None], kseg[:, None, :, None],
        k0, l, causal)


def dkv_walk_map(l: int, causal: bool, q_segment_ids, kv_segment_ids,
                 lse: torch.Tensor, rows: int = DKV_F32_ROWS,
                 keys: int = DKV_F32_KEYS) -> torch.Tensor:
    """(B, H, ceil(L / keys), ceil(L / rows)) bool: the row tiles each
    key block of the f32 dk/dv kernel walks (`dkv_tile_walked`), for lse
    (B, H, L) and segment ids (B, L) or None; by default in the dk/dv
    kernel's tiles."""
    return _walk_map(l, causal, q_segment_ids, kv_segment_ids,
                     lse <= _LSE_NONE, rows, keys)


def dq_walk_map(l: int, causal: bool, q_segment_ids, kv_segment_ids,
                lse: torch.Tensor) -> torch.Tensor:
    """(B, H, ceil(L / DQ_F32_ROWS), ceil(L / DQ_F32_KEYS)) bool: the key
    tiles each row block of the f32 dq kernel walks (`dkv_tile_walked` in
    its tiles)."""
    return dkv_walk_map(l, causal, q_segment_ids, kv_segment_ids, lse,
                        rows=DQ_F32_ROWS, keys=DQ_F32_KEYS).transpose(
                            -1, -2).contiguous()


def no_visible_key(l: int, causal: bool, q_segment_ids,
                   kv_segment_ids) -> torch.Tensor:
    """(B, L) bool: the rows with no key of their segment below their
    frontier (F_r = r + 1 under `causal`, else L), for segment ids (B, L)
    or None (one segment: no such row; then (1, L)). Such a row returns
    the mean of V over [0, F_r) with lse = -1e30 + log F_r <= -1e29."""
    if q_segment_ids is None:
        return torch.zeros((1, l), dtype=torch.bool)
    qs = q_segment_ids.to(torch.int32)
    ks = kv_segment_ids.to(device=qs.device, dtype=torch.int32)
    same = qs[:, :, None] == ks[:, None, :]                 # (B, L, L)
    if causal:
        same = same & torch.ones((l, l), dtype=torch.bool,
                                 device=qs.device).tril()
    return ~same.any(-1)


def fwd_walk_map(l: int, causal: bool, q_segment_ids, kv_segment_ids, *,
                 rows: int = FWD_F32_ROWS,
                 keys: Optional[int] = None) -> torch.Tensor:
    """(B, 1, ceil(L / rows), ceil(L / keys)) bool: the key tiles each row
    block of the f32 forward walks (`fwd_tile_walked`, the rows that see
    no key of their segment from `no_visible_key`), in tiles of `rows`
    rows and `keys` keys (by default FWD_F32_TILES[rows]). The same for
    every head (B is 1 without segment ids); with the forward's lse it is
    the dq kernel's map in the same tiles (`dq_walk_map`)."""
    keys = keys or FWD_F32_TILES[rows]
    none = no_visible_key(l, causal, q_segment_ids, kv_segment_ids)
    return _walk_map(l, causal, q_segment_ids, kv_segment_ids,
                     none[:, None], rows, keys).transpose(-1,
                                                          -2).contiguous()


def _lib():
    from wedetect_tpu_torch.ops import _build

    lib = _build.load("flash_attn")
    if not getattr(lib, "_typed_fa", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_fwd.argtypes = [p, p, p, p, p, p, p, i, i, i,
                                            i, i, ctypes.c_float, i, p]
        lib.flash_attention_fwd.restype = ctypes.c_int
        lib._typed_fa = True
    return lib


def _sm90_lib():
    from wedetect_tpu_torch.ops import _build

    lib = _build.load("flash_attn_sm90")
    if not getattr(lib, "_typed_fa", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_fwd_sm90.argtypes = [p] * 7 + [i] * 5 + [
            ctypes.c_float, p]
        lib.flash_attention_fwd_sm90.restype = ctypes.c_int
        lib._typed_fa = True
    return lib


def type_fwd_f32(lib):
    """Set the C signatures of csrc/flash_attn_f32.cu's entries on a loaded
    library (also a variant build's); returns it."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_fwd_f32.argtypes = [p] * 7 + [i] * 5 + [
        ctypes.c_float, i, p, p]
    lib.flash_attention_fwd_f32.restype = ctypes.c_int
    lib.flash_attention_fwd_f32_keys.argtypes = [i]
    lib.flash_attention_fwd_f32_keys.restype = ctypes.c_int
    lib._typed_fa = True
    return lib


def fwd_f32_tile(b: int, l: int, h: int, sms: int):
    """(rows, keys): the f32 forward's tile for B x H x L rows on a card
    of `sms` SMs (one block an SM): the narrow tile, 64 rows, when its
    waves of half-size blocks (each `_NARROW_BLOCK_COST` of a wide
    block's time) end before the wide tile's waves; else the wide one,
    128 rows. At the ViT's 480x640 image (1, 1280, 16) the wide tile's 160
    blocks leave a second wave on 28 of 132 SMs, and the narrow one took
    9% less; at its training shape (1, 4224, 16: four full waves) the
    wide one took 17% less (PERF.md §6, tools/time_k3.py --variant)."""
    wide = -(-b * h * -(-l // 128) // sms)
    narrow = -(-b * h * -(-l // 64) // sms)
    rows = 64 if _NARROW_BLOCK_COST * narrow < wide else 128
    return rows, FWD_F32_TILES[rows]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _fwd_f32_lib():
    from wedetect_tpu_torch.ops import _build

    lib = _build.load("flash_attn_f32")
    return lib if getattr(lib, "_typed_fa", False) else type_fwd_f32(lib)


def _bwd_lib():
    from wedetect_tpu_torch.ops import _build

    lib = _build.load("flash_attn_bwd")
    if not getattr(lib, "_typed_fa", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attention_bwd_dq.argtypes = [p] * 9 + [i] * 5 + [f, i, p]
        lib.flash_attention_bwd_dkv.argtypes = [p] * 10 + [i] * 5 + [f, i, p]
        lib.flash_attention_bwd_dq.restype = ctypes.c_int
        lib.flash_attention_bwd_dkv.restype = ctypes.c_int
        lib._typed_fa = True
    return lib


def _bwd_f32_lib():
    from wedetect_tpu_torch.ops import _build

    lib = _build.load("flash_attn_bwd_f32")
    if not getattr(lib, "_typed_fa", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attention_bwd_dkv_f32.argtypes = [p] * 10 + [i] * 5 + [
            f, p, p]
        lib.flash_attention_bwd_dq_f32.argtypes = [p] * 9 + [i] * 5 + [
            f, p, p]
        lib.flash_attention_bwd_dkv_f32.restype = ctypes.c_int
        lib.flash_attention_bwd_dq_f32.restype = ctypes.c_int
        lib._typed_fa = True
    return lib


def _bwd_sm90_lib():
    from wedetect_tpu_torch.ops import _build

    lib = _build.load("flash_attn_bwd_sm90")
    if not getattr(lib, "_typed_fa", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attention_bwd_dq_sm90.argtypes = [p] * 9 + [i] * 4 + [f, p]
        lib.flash_attention_bwd_dkv_sm90.argtypes = [p] * 10 + [i] * 4 + [f,
                                                                          p]
        lib.flash_attention_bwd_dq_sm90.restype = ctypes.c_int
        lib.flash_attention_bwd_dkv_sm90.restype = ctypes.c_int
        lib._typed_fa = True
    return lib


def _route(name: str, dtype: torch.dtype, d: int) -> str:
    if dtype == torch.float32:
        return "simt"
    if dtype != torch.bfloat16:
        raise TypeError(f"{name}: dtype {dtype} (float32 or bfloat16 "
                        "only)")
    return "sm90" if d == 64 else "simt"


def fwd_route(dtype: torch.dtype, d: int) -> str:
    """The K3 forward kernel a CUDA input takes: "f32"
    (csrc/flash_attn_f32.cu, FFMA register tiles fed by cp.async) for f32
    at D = 64; "sm90" (csrc/flash_attn_sm90.cu, wgmma + TMA) for bf16 at
    D = 64; "simt" (csrc/flash_attn.cu) for every other head dim, padded
    to the next of SIMT_HEAD_DIMS. Raises TypeError for other types."""
    if dtype == torch.float32 and d == 64:
        return "f32"
    return _route("flash_attention", dtype, d)


def bwd_route(dtype: torch.dtype, d: int) -> str:
    """The K3 backward kernels a CUDA input takes: "sm90"
    (csrc/flash_attn_bwd_sm90.cu, wgmma + TMA) for bf16 at D = 64;
    "simt" (csrc/flash_attn_bwd.cu) for f32 and for bf16 at any other
    head dim. `dkv_route` and `dq_route` refine it: f32 at D = 64 takes
    the FFMA kernels. Raises for other types."""
    return _route("flash_attention_bwd", dtype, d)


def dkv_route(dtype: torch.dtype, d: int) -> str:
    """The K3-bwd-dkv kernel a CUDA input takes: "f32"
    (csrc/flash_attn_bwd_f32.cu, FFMA register tiles fed by cp.async) for
    f32 at D = 64; "sm90" (csrc/flash_attn_bwd_sm90.cu) for bf16 at
    D = 64, as `bwd_route`; "simt" (csrc/flash_attn_bwd.cu) for every
    other head dim, padded to the next of SIMT_HEAD_DIMS. Raises
    TypeError for other types."""
    if dtype == torch.float32 and d == 64:
        return "f32"
    return bwd_route(dtype, d)


def dq_route(dtype: torch.dtype, d: int) -> str:
    """The K3-bwd-dq kernel a CUDA input takes: "f32"
    (csrc/flash_attn_bwd_f32.cu:flash_attention_bwd_dq_f32, FFMA register
    tiles fed by cp.async) for f32 at D = 64; `bwd_route`'s answer
    otherwise ("sm90" for bf16 at D = 64, else "simt"). Raises TypeError
    for other types."""
    return dkv_route(dtype, d)


def _check_cuda(name, q, *others):
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: dtype {q.dtype} (float32 or bfloat16 "
                        "only)")
    if any(t.dtype != q.dtype or t.device != q.device for t in others):
        raise TypeError(f"{name}: k, v (and dO) must match q's dtype and "
                        "device")
    if not all(t.is_contiguous() for t in (q, *others)):
        raise ValueError(f"{name}: q, k, v (and dO) must be contiguous")
    simt_head_dim(q.shape[-1], name)


def _segs(q, q_segment_ids, kv_segment_ids):
    if q_segment_ids is None:
        return [None, None]
    return [t.to(device=q.device, dtype=torch.int32).contiguous()
            for t in (q_segment_ids, kv_segment_ids)]


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch_fwd(name, fn, q, k, v, q_segment_ids, kv_segment_ids, causal,
                sm_scale, *tail):
    """Launch one K3 forward kernel `fn`: (O, lse)."""
    b, l, h, d = q.shape
    segs = _segs(q, q_segment_ids, kv_segment_ids)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, l), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), *map(_ptr, segs),
                 o.data_ptr(), lse.data_ptr(), b, l, h, d, int(causal),
                 float(sm_scale), *tail, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    return o, lse


def flash_attention_fwd_sm90(q, k, v, q_segment_ids=None,
                             kv_segment_ids=None, causal=False,
                             sm_scale=1.0):
    """One launch of K3's bf16 kernel (wgmma + TMA) on CUDA tensors:
    (O (B, L, H, 64), lse (B, H, L) f32). Raises for input it does not
    take."""
    name = "flash_attention_fwd_sm90"
    _check(q, k, v, q_segment_ids, kv_segment_ids)
    _check_cuda(name, q, k, v)
    _check_sm90(name, q=q, k=k, v=v)
    o, lse = _launch_fwd(name, _sm90_lib().flash_attention_fwd_sm90, q, k,
                         v, q_segment_ids, kv_segment_ids, causal, sm_scale)
    flash_attention_fwd_sm90.launches += 1
    return o, lse


flash_attention_fwd_sm90.launches = 0


def _walked_ptr(name, walked, q, block):
    """`walked`'s pointer (None for None), after checking that it is a
    contiguous int32 tensor (B, H, ceil(L / block)) on q's device."""
    if walked is None:
        return None
    b, l, h, _ = q.shape
    want = (b, h, -(-l // block))
    if walked.dtype != torch.int32 or tuple(walked.shape) != want \
            or walked.device != q.device or not walked.is_contiguous():
        raise ValueError(f"{name}: walked must be contiguous int32 {want} "
                         "on q's device")
    return walked.data_ptr()


def flash_attention_fwd_f32(q, k, v, q_segment_ids=None, kv_segment_ids=None,
                            causal=False, sm_scale=1.0, walked=None,
                            rows=None):
    """One launch of K3's f32 kernel (FFMA register tiles fed by cp.async,
    D = 64) on CUDA tensors: (O (B, L, H, 64), lse (B, H, L) f32). `rows`:
    the tile's rows (128 or 64); by default `fwd_f32_tile`'s for the card.
    `walked`: None, or a contiguous int32 CUDA tensor
    (B, H, ceil(L / rows)) that gets each row block's count of walked key
    tiles (`fwd_walk_map` in that tile counts the same). Raises for
    another type or head dim, for a q, k or v that is not 16-byte aligned
    (cp.async copies 16 bytes), and for a wrong `walked`."""
    name = "flash_attention_fwd_f32"
    _check(q, k, v, q_segment_ids, kv_segment_ids)
    _check_cuda(name, q, k, v)
    if q.dtype != torch.float32:
        raise TypeError(f"{name}: the f32 kernel takes float32, got "
                        f"{q.dtype}")
    if q.shape[-1] != 64:
        raise ValueError(f"{name}: the f32 kernel takes head dim 64, got "
                         f"{q.shape[-1]}")
    _check_aligned(name, "cp.async", q=q, k=k, v=v)
    if rows is None:
        b, l, h, _ = q.shape
        rows, _ = fwd_f32_tile(b, l, h, _sm_count(q.device.index or 0))
    walked_ptr = _walked_ptr(name, walked, q, rows)
    o, lse = _launch_fwd(name, _fwd_f32_lib().flash_attention_fwd_f32, q, k,
                         v, q_segment_ids, kv_segment_ids, causal, sm_scale,
                         rows, walked_ptr)
    flash_attention_fwd_f32.launches += 1
    return o, lse


flash_attention_fwd_f32.launches = 0


def _fwd_kernel(q, k, v, q_segment_ids, kv_segment_ids, causal, sm_scale):
    """One launch of K3: (O, lse). The kernel goes by `fwd_route`; every
    launch is counted in `flash_attention.launches`, the bf16 wgmma
    kernel's also in `flash_attention_fwd_sm90.launches`, the f32 FFMA
    kernel's in `flash_attention_fwd_f32.launches`."""
    args = (q_segment_ids, kv_segment_ids, causal, sm_scale)
    route = fwd_route(q.dtype, q.shape[-1])
    if route == "sm90":
        o, lse = flash_attention_fwd_sm90(q, k, v, *args)
    elif route == "f32":
        o, lse = flash_attention_fwd_f32(q, k, v, *args)
    else:
        _check_cuda("flash_attention", q, k, v)
        d = q.shape[-1]
        o, lse = _launch_fwd("flash_attention", _lib().flash_attention_fwd,
                             *pad_head_dim(simt_head_dim(d), q, k, v), *args,
                             int(q.dtype == torch.bfloat16))
        o = _unpad(o, d)
    flash_attention.launches += 1
    return o, lse


def _forward(q, k, v, q_segment_ids, kv_segment_ids, causal, sm_scale):
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, q_segment_ids=q_segment_ids,
            kv_segment_ids=kv_segment_ids, causal=causal,
            sm_scale=sm_scale, return_lse=True)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _fwd_kernel(q, k, v, q_segment_ids, kv_segment_ids, causal,
                       sm_scale)


def _unpad(t, d):
    """A SIMT output (..., width) cut back to the caller's head dim d."""
    return t if t.shape[-1] == d else t[..., :d].contiguous()


def _check_rows(name, lse, delta, q):
    b, l, h, _ = q.shape
    for tname, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or tuple(t.shape) != (b, h, l) \
                or not t.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous f32 "
                             f"{(b, h, l)}")


def _check_bwd(name, q, k, v, do, lse, delta, kw):
    """The backward kernels' input rules; `kw` holds the segment ids."""
    _check(q, k, v, kw["q_segment_ids"], kw["kv_segment_ids"])
    _check_cuda(name, q, k, v, do)
    _check_rows(name, lse, delta, q)


def _launch_bwd(name, fn, q, k, v, do, lse, delta, outs, dims, kw, *tail):
    """Launch one K3 backward kernel `fn` writing `outs`; `dims` are the
    shape arguments it takes, `kw` the segment ids, causal and
    sm_scale."""
    segs = _segs(q, kw["q_segment_ids"], kw["kv_segment_ids"])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), *map(_ptr, segs),
                 do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 *(t.data_ptr() for t in outs), *dims, int(kw["causal"]),
                 float(kw["sm_scale"]), *tail, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def _check_aligned(name, why, **tensors):
    """Each tensor 16-byte aligned: the kernel copies 16-byte pieces."""
    for tname, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {tname} must be 16-byte aligned "
                             f"({why})")


def _check_sm90(name, **tensors):
    """The wgmma kernels take bf16 at D = 64 only, and read their
    tensors (q, k, v and dO) through TMA, which needs each 16-byte
    aligned."""
    q = tensors["q"]
    if q.dtype != torch.bfloat16 or q.shape[-1] != 64:
        raise ValueError(f"{name}: bf16 at head dim 64 only, got "
                         f"{q.dtype} at {q.shape[-1]}")
    _check_aligned(name, "TMA", **tensors)


def flash_attention_bwd_dq_sm90(q, k, v, do, lse, delta, *,
                                q_segment_ids=None, kv_segment_ids=None,
                                causal=False, sm_scale=1.0):
    """One launch of K3-bwd-dq's bf16 kernel (wgmma + TMA) on CUDA
    tensors: dq (B, L, H, 64). Raises for input it does not take."""
    name = "flash_attention_bwd_dq_sm90"
    kw = dict(q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
              causal=causal, sm_scale=sm_scale)
    _check_bwd(name, q, k, v, do, lse, delta, kw)
    _check_sm90(name, q=q, k=k, v=v, do=do)
    dq = torch.empty_like(q)
    _launch_bwd(name, _bwd_sm90_lib().flash_attention_bwd_dq_sm90, q, k, v,
                do, lse, delta, (dq,), q.shape[:3], kw)
    flash_attention_bwd_dq_sm90.launches += 1
    return dq


def flash_attention_bwd_dkv_sm90(q, k, v, do, lse, delta, *,
                                 q_segment_ids=None, kv_segment_ids=None,
                                 causal=False, sm_scale=1.0):
    """One launch of K3-bwd-dkv's bf16 kernel (wgmma + TMA) on CUDA
    tensors: (dk, dv), each (B, L, H, 64). Raises for input it does not
    take."""
    name = "flash_attention_bwd_dkv_sm90"
    kw = dict(q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
              causal=causal, sm_scale=sm_scale)
    _check_bwd(name, q, k, v, do, lse, delta, kw)
    _check_sm90(name, q=q, k=k, v=v, do=do)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_bwd(name, _bwd_sm90_lib().flash_attention_bwd_dkv_sm90, q, k,
                v, do, lse, delta, (dk, dv), q.shape[:3], kw)
    flash_attention_bwd_dkv_sm90.launches += 1
    return dk, dv


def _check_f32(name, q, k, v, do, lse, delta, kw, walked, block):
    """The f32 kernels' input rules: float32 at D = 64, q, k, v and dO
    16-byte aligned (cp.async copies 16 bytes), and `walked` None or a
    contiguous int32 tensor (B, H, ceil(L / block)) on q's device.
    Returns walked's pointer (None for None)."""
    _check_bwd(name, q, k, v, do, lse, delta, kw)
    if q.dtype != torch.float32:
        raise TypeError(f"{name}: the f32 kernel takes float32, got "
                        f"{q.dtype}")
    if q.shape[-1] != 64:
        raise ValueError(f"{name}: the f32 kernel takes head dim 64, got "
                         f"{q.shape[-1]}")
    _check_aligned(name, "cp.async", q=q, k=k, v=v, do=do)
    return _walked_ptr(name, walked, q, block)


def flash_attention_bwd_dkv_f32(q, k, v, do, lse, delta, *,
                                q_segment_ids=None, kv_segment_ids=None,
                                causal=False, sm_scale=1.0, walked=None):
    """One launch of K3-bwd-dkv's f32 kernel (FFMA register tiles fed by
    cp.async, D = 64) on CUDA tensors: (dk, dv), each (B, L, H, 64).
    `walked`: None, or a contiguous int32 CUDA tensor
    (B, H, ceil(L / DKV_F32_KEYS)) that gets each key block's count of
    walked row tiles (`dkv_walk_map` counts the same). Raises for another
    type or head dim, for a q, k, v or dO that is not 16-byte aligned
    (cp.async copies 16 bytes), and for a wrong `walked`."""
    name = "flash_attention_bwd_dkv_f32"
    kw = dict(q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
              causal=causal, sm_scale=sm_scale)
    walked_ptr = _check_f32(name, q, k, v, do, lse, delta, kw, walked,
                            DKV_F32_KEYS)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_bwd(name, _bwd_f32_lib().flash_attention_bwd_dkv_f32, q, k, v,
                do, lse, delta, (dk, dv), q.shape, kw, walked_ptr)
    flash_attention_bwd_dkv_f32.launches += 1
    return dk, dv


def flash_attention_bwd_dq_f32(q, k, v, do, lse, delta, *,
                               q_segment_ids=None, kv_segment_ids=None,
                               causal=False, sm_scale=1.0, walked=None):
    """One launch of K3-bwd-dq's f32 kernel (FFMA register tiles fed by
    cp.async, D = 64) on CUDA tensors: dq (B, L, H, 64). `walked`: None,
    or a contiguous int32 CUDA tensor (B, H, ceil(L / DQ_F32_ROWS)) that
    gets each row block's count of walked key tiles (`dq_walk_map` counts
    the same). Raises for another type or head dim, for a q, k, v or dO
    that is not 16-byte aligned (cp.async copies 16 bytes), and for a
    wrong `walked`."""
    name = "flash_attention_bwd_dq_f32"
    kw = dict(q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
              causal=causal, sm_scale=sm_scale)
    walked_ptr = _check_f32(name, q, k, v, do, lse, delta, kw, walked,
                            DQ_F32_ROWS)
    dq = torch.empty_like(q)
    _launch_bwd(name, _bwd_f32_lib().flash_attention_bwd_dq_f32, q, k, v,
                do, lse, delta, (dq,), q.shape, kw, walked_ptr)
    flash_attention_bwd_dq_f32.launches += 1
    return dq


flash_attention_bwd_dq_sm90.launches = 0
flash_attention_bwd_dkv_sm90.launches = 0
flash_attention_bwd_dkv_f32.launches = 0
flash_attention_bwd_dq_f32.launches = 0


def flash_attention_bwd_dq(q, k, v, do, lse, delta, *, q_segment_ids=None,
                           kv_segment_ids=None, causal=False, sm_scale=1.0):
    """One launch of K3-bwd-dq on CUDA tensors: dq (B, L, H, D). lse and
    delta (B, H, L) f32 (`row_delta`). The kernel goes by `dq_route`;
    every launch is counted here, the f32 kernel's also in
    `flash_attention_bwd_dq_f32.launches`, the bf16 wgmma kernel's in
    `flash_attention_bwd_dq_sm90.launches`."""
    name = "flash_attention_bwd_dq"
    kw = dict(q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
              causal=causal, sm_scale=sm_scale)
    route = dq_route(q.dtype, q.shape[-1])
    if route == "f32":
        dq = flash_attention_bwd_dq_f32(q, k, v, do, lse, delta, **kw)
    elif route == "sm90":
        dq = flash_attention_bwd_dq_sm90(q, k, v, do, lse, delta, **kw)
    else:
        _check_bwd(name, q, k, v, do, lse, delta, kw)
        d = q.shape[-1]
        qp, kp, vp, dop = pad_head_dim(simt_head_dim(d), q, k, v, do)
        dq = torch.empty_like(qp)
        _launch_bwd(name, _bwd_lib().flash_attention_bwd_dq, qp, kp, vp, dop,
                    lse, delta, (dq,), qp.shape, kw,
                    int(q.dtype == torch.bfloat16))
        dq = _unpad(dq, d)
    flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, *, q_segment_ids=None,
                            kv_segment_ids=None, causal=False,
                            sm_scale=1.0):
    """One launch of K3-bwd-dkv on CUDA tensors: (dk, dv), each
    (B, L, H, D). The kernel goes by `dkv_route`; every launch is counted
    here, the f32 kernel's also in `flash_attention_bwd_dkv_f32.launches`,
    the bf16 wgmma kernel's in `flash_attention_bwd_dkv_sm90.launches`."""
    name = "flash_attention_bwd_dkv"
    kw = dict(q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
              causal=causal, sm_scale=sm_scale)
    route = dkv_route(q.dtype, q.shape[-1])
    if route == "f32":
        dk, dv = flash_attention_bwd_dkv_f32(q, k, v, do, lse, delta, **kw)
    elif route == "sm90":
        dk, dv = flash_attention_bwd_dkv_sm90(q, k, v, do, lse, delta, **kw)
    else:
        _check_bwd(name, q, k, v, do, lse, delta, kw)
        d = q.shape[-1]
        qp, kp, vp, dop = pad_head_dim(simt_head_dim(d), q, k, v, do)
        dk, dv = torch.empty_like(kp), torch.empty_like(vp)
        _launch_bwd(name, _bwd_lib().flash_attention_bwd_dkv, qp, kp, vp,
                    dop, lse, delta, (dk, dv), qp.shape, kw,
                    int(q.dtype == torch.bfloat16))
        dk, dv = _unpad(dk, d), _unpad(dv, d)
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd(q, k, v, o, lse, do, *, q_segment_ids=None,
                        kv_segment_ids=None, causal=False, sm_scale=1.0):
    """(dq, dk, dv) of flash_attention from the saved O and lse. CUDA
    tensors: K3-bwd-dq and K3-bwd-dkv, one launch each (`dq_route`,
    `dkv_route`); CPU tensors: the plain version."""
    kw = dict(q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
              causal=causal, sm_scale=sm_scale)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: unsupported device "
                         f"{q.device}")
    delta = row_delta(o, do)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    """K3 with its backward: saves q, k, v, the segment ids, O and lse
    (never an L x L matrix)."""

    @staticmethod
    def forward(ctx, q, k, v, q_segment_ids, kv_segment_ids, causal,
                sm_scale):
        o, lse = _forward(q, k, v, q_segment_ids, kv_segment_ids, causal,
                          sm_scale)
        ctx.save_for_backward(q, k, v, q_segment_ids, kv_segment_ids, o,
                              lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, qs, ks, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(
            q, k, v, o, lse, do.contiguous(), q_segment_ids=qs,
            kv_segment_ids=ks, causal=ctx.causal, sm_scale=ctx.sm_scale)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    q_segment_ids: Optional[torch.Tensor] = None,
                    kv_segment_ids: Optional[torch.Tensor] = None,
                    causal: bool = False, sm_scale: float = 1.0,
                    return_lse: bool = False):
    """(B, L, H, D) square attention -> (B, L, H, D) [, lse (B, H, L)].

    CUDA tensors: one launch of the CUDA kernel, counted in
    `flash_attention.launches`. CPU tensors: the plain version.
    Differentiable in q, k and v (module docstring).
    """
    _check(q, k, v, q_segment_ids, kv_segment_ids)
    o, lse = _Flash.apply(q, k, v, q_segment_ids, kv_segment_ids, causal,
                          float(sm_scale))
    return (o, lse) if return_lse else o


flash_attention.launches = 0
