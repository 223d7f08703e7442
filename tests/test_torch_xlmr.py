"""The port's XLM-R text tower against the flax TextTower on the same
weights (JAX init carried across with from_jax_text_params) and the
same padded token ids. Tolerance atol = rtol = 1e-5 on the unit-norm
outputs: f32 on both sides, 2 layers of matmuls in another order."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from wedetect_tpu.configs import TextCfg as JTextCfg
from wedetect_tpu.nn.xlmr import TextTower as JTextTower
from wedetect_tpu.nn.xlmr import convert_hf_text_tower
from wedetect_tpu_torch.ckpt.convert import from_jax_text_params
from wedetect_tpu_torch.configs import TextCfg
from wedetect_tpu_torch.nn.xlmr import TextTower

KW = dict(hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
          vocab_size=300, max_position_embeddings=40, head_out=32)


def _ids():
    rng = np.random.default_rng(0)
    ids = rng.integers(3, KW["vocab_size"], (5, 12)).astype(np.int32)
    lens = np.array([12, 7, 3, 10, 5])
    ids[:, 0] = 0
    for i, n in enumerate(lens):
        ids[i, n - 1] = 2
        ids[i, n:] = 1
    return ids, (ids != 1).astype(np.int32)


def _jax_params(seed=0):
    ids, mask = _ids()
    params = JTextTower(JTextCfg(**KW)).init(
        jax.random.PRNGKey(seed), jnp.asarray(ids), jnp.asarray(mask))
    rng = np.random.default_rng(seed)
    # non-trivial LayerNorm affine so the norms are exercised
    return jax.tree_util.tree_map_with_path(
        lambda p, x: (np.asarray(x) + rng.normal(0, 0.1, x.shape)
                      .astype(np.float32))
        if p[-1].key in ("scale", "bias") else np.asarray(x),
        params["params"])


def test_text_tower_matches_flax():
    params = _jax_params()
    ids, mask = _ids()
    want = JTextTower(JTextCfg(**KW)).apply(
        {"params": jax.tree.map(jnp.asarray, params)}, jnp.asarray(ids),
        jnp.asarray(mask))
    tower = TextTower(TextCfg(**KW)).eval()
    tower.load_state_dict(from_jax_text_params(params, TextCfg(**KW)),
                          strict=True)
    with torch.no_grad():
        got = tower(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0,
                               rtol=1e-5)


def test_text_weights_round_trip():
    """from_jax_text_params -> the JAX package's own HF converter gives
    back the original params exactly: the port's keys are HF's."""
    params = _jax_params(seed=1)
    sd = from_jax_text_params(params, TextCfg(**KW))
    back = convert_hf_text_tower({k: v.numpy() for k, v in sd.items()},
                                 JTextCfg(**KW))
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, x in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), x)
