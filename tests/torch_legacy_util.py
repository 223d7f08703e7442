"""Shared pieces of the port's legacy-module tests (RepVGG, the
YOLO-World / YOLOv5 / YOLOv8 necks, the YOLOv5 head and loss, CLIP): a
flax init with random BN statistics and perturbed scales and biases,
carried into the port module with `from_jax_module`, and NHWC <-> NCHW
comparisons.

Tolerance atol = rtol = 1e-4: f32 on both sides, convolutions and
matmuls summed in another order by XLA and oneDNN.
"""

import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

from wedetect_tpu_torch.ckpt.convert import from_jax_module

ATOL = RTOL = 1e-4


def random_variables(shapes, seed):
    """numpy variables of the tree `shapes` (jax.eval_shape of an init):
    kernels N(0, 1 / fan_in), embeddings and other params N(0, 0.02),
    scales 1 + N(0, 0.2), biases N(0, 0.2); BN statistics mean
    N(0, 0.2), var U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = path[-1].key
        stats = path[0].key == "batch_stats"
        if stats and name == "mean" or not stats and name == "bias":
            v = rng.normal(0, 0.2, x.shape)
        elif stats and name == "var":
            v = rng.uniform(0.5, 1.5, x.shape)
        elif name == "kernel":
            v = rng.normal(0, 1 / np.sqrt(np.prod(x.shape[:-1])), x.shape)
        elif name == "scale":
            v = 1 + rng.normal(0, 0.2, x.shape)
        else:
            v = rng.normal(0, 0.02, x.shape)
        return v.astype(np.float32)

    v = jax.tree_util.tree_map_with_path(leaf, shapes)
    return dict(v)


def x_nhwc(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x).transpose(0, 3, 1, 2)))


def close_nchw(got, want, atol=ATOL, rtol=RTOL):
    """got: NCHW torch tensor, want: NHWC array."""
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=atol, rtol=rtol)


def jax_init(module, seed, *args, **kw):
    """Random numpy variables for `module` on `args` (numpy): the init's
    tree (traced, not run) filled by `random_variables`."""
    jargs = jax.tree.map(jnp.asarray, args)
    shapes = jax.eval_shape(
        lambda *a: module.init(jax.random.PRNGKey(0), *a, **kw), *jargs)
    return random_variables(shapes, seed)


def jax_apply(module, v, *args, train=False, **kw):
    """Apply (jitted) with numpy variables; train=True returns (out, new
    stats)."""
    jv = jax.tree.map(jnp.asarray, v)
    jargs = jax.tree.map(jnp.asarray, args)
    if not train:
        return jax.jit(functools.partial(module.apply, **kw))(jv, *jargs)
    out, mut = jax.jit(functools.partial(
        module.apply, train=True, mutable=["batch_stats"], **kw))(jv, *jargs)
    return out, jax.tree.map(np.asarray, mut["batch_stats"])


def port_from(kind, v, module, **kw):
    """Load the JAX variables into the port `module` (strict), eval."""
    module.load_state_dict(from_jax_module(kind, v, **kw), strict=True)
    return module.eval()


def running_stats_match(module, kind, v, new_stats, **kw):
    """The port module's BN running statistics after its train-mode call
    against flax's `batch_stats` after one update (carried through the
    same writer)."""
    want = from_jax_module(kind, {"params": v["params"],
                                  "batch_stats": new_stats}, **kw)
    sd = module.state_dict()
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert keys
    for k in keys:
        np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(),
                                   atol=ATOL, rtol=RTOL, err_msg=k)
