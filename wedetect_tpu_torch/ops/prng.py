"""A torch twin of the JAX PRNG that the generation samplers use.

JAX's default generator (threefry2x32, with `jax_threefry_partitionable`
on, the default of the JAX version the reference package pins) computed
with integer ops on int64 tensors masked to 32 bits, so that the same
code runs on the CPU and on the card. With it a seed gives the same
random bits, uniforms and categorical draws as `jax.random` does:

- `PRNGKey(seed)`: the key (0, seed mod 2**32), as JAX builds it from an
  int32 seed;
- `split(key, n)`: key i is threefry(key, (0, i));
- `fold_in(key, d)`: threefry(key, (0, d)), the same hash;
- `random_bits(key, shape)`: element i (flat, row-major) is the xor of
  the two words of threefry(key, (i >> 32, i & 0xffffffff));
- `uniform`: the top 23 bits as the mantissa of a float in [1, 2),
  minus 1, scaled to [minval, maxval) by one fused multiply-add (as XLA
  fuses it) and clamped below at minval;
- `gumbel`: JAX's "low" mode, -log(-log(uniform(tiny, 1)));
- `categorical`: argmax(gumbel + logits), the first index on a tie.

Bits and uniforms are bitwise equal to JAX's; the logarithms are
torch's, which may differ from XLA's by an ulp. A key is an int64
tensor of shape (..., 2) holding two uint32 words; every function takes
a batch of keys (leading dims) and returns that batch in front of its
own shape.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

_M = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY_F32 = float(np.finfo(np.float32).tiny)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _M) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of the count pair (x1, x2)
    under the key (k1, k2); all int64 tensors holding uint32 values,
    broadcast together. Returns the two output words."""
    k3 = k1 ^ k2 ^ 0x1BD11BDA
    ks = (k1, k2, k3)
    x = [(x1 + k1) & _M, (x2 + k2) & _M]
    for i in range(5):
        for r in _ROT[i % 2]:
            x[0] = (x[0] + x[1]) & _M
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _M
        x[1] = (x[1] + ks[(i + 2) % 3] + (i + 1)) & _M
    return x[0], x[1]


def PRNGKey(seed, device=None) -> torch.Tensor:  # noqa: N802 (JAX's name)
    """The key of an integer seed (a Python int or an int tensor of any
    shape): (0, seed mod 2**32), as `jax.random.PRNGKey` of an int32."""
    s = torch.as_tensor(seed, dtype=torch.int64, device=device) & _M
    return torch.stack([torch.zeros_like(s), s], dim=-1)


def _hash(key: torch.Tensor, hi, lo):
    """threefry(key, (hi, lo)) with the key's batch dims in front of the
    counts' dims."""
    nb = key.dim() - 1
    nc = max(hi.dim(), lo.dim())
    k1 = key[..., 0].reshape(key.shape[:-1] + (1,) * nc)
    k2 = key[..., 1].reshape(key.shape[:-1] + (1,) * nc)
    hi = hi.reshape((1,) * nb + hi.shape)
    lo = lo.reshape((1,) * nb + lo.shape)
    return threefry2x32(k1, k2, hi, lo)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """(..., 2) -> (..., num, 2): `jax.random.split`."""
    lo = torch.arange(num, dtype=torch.int64, device=key.device)
    b1, b2 = _hash(key, torch.zeros_like(lo), lo)
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """`jax.random.fold_in`: data an int or an int tensor broadcast
    against the key's batch dims."""
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _M
    b1, b2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits an element (int64 holding uint32):
    key.shape[:-1] + shape."""
    shape = tuple(shape)
    n = int(np.prod(shape, dtype=np.int64))
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    b1, b2 = _hash(key, (idx >> 32).reshape(shape), (idx & _M).reshape(shape))
    return b1 ^ b2


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """f32 uniforms in [minval, maxval), bitwise `jax.random.uniform`."""
    bits = random_bits(key, shape)
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = fbits.view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    # XLA fuses the scale and shift into one fused multiply-add: the f32
    # product is exact in f64, so only the sum rounds (then to f32)
    x = (floats.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, x)


def gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """f32 standard Gumbel draws (`jax.random.gumbel`, mode "low")."""
    return -torch.log(-torch.log(uniform(key, shape, _TINY_F32, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """One draw over the last axis of `logits` (f32): a single key (2,)
    draws the whole array as `jax.random.categorical(key, logits)`
    does; a batch of keys (B.., 2) draws each row of logits (B.., V)
    with its own key, as a vmap of it over the rows does. int64."""
    shape = logits.shape if key.dim() == 1 else logits.shape[key.dim() - 1:]
    return torch.argmax(gumbel(key, shape) + logits, dim=-1)
