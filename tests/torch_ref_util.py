"""Shared fixtures of the WeDetect-Ref port tests: tiny configs for both
packages, JAX params carried into the port, and a scoring batch laid out
both jointly and split at the shared prefix."""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from wedetect_tpu.models.ref import RefModules as JRefModules
from wedetect_tpu.nn import qwen3vl as JQ
from wedetect_tpu.nn.qwen3vl import get_rope_index_single_image
from wedetect_tpu_torch.ckpt.convert_ref import from_jax_ref_params
from wedetect_tpu_torch.models.ref import RefModules
from wedetect_tpu_torch.nn import qwen3vl as TQ

IMG, VSTART, OBJ = 120, 122, 123


class FakeTok:
    """Maps each character to a small id; deterministic."""

    def encode(self, text, add_special_tokens=False):
        return [(ord(ch) % 80) + 1 for ch in text][:10]


def cfg_kw(head_dim=16, vision_hidden=32, vision_heads=4):
    vision = dict(depth=4, hidden=vision_hidden, heads=vision_heads,
                  intermediate=64, patch=4, temporal_patch=2, merge=2,
                  out_hidden=48, num_pos_emb=64, deepstack_idx=(1, 2))
    section = {16: (4, 2, 2), 128: (24, 20, 20)}[head_dim]
    text = dict(vocab_size=128, hidden=48, layers=2, heads=4, kv_heads=2,
                head_dim=head_dim, intermediate=96, rope_theta=1000.0,
                mrope_section=section)
    return vision, text


def cfgs(**kw):
    """(JAX RefCfg, port RefCfg) with the same fields."""
    vision, text = cfg_kw(**kw)
    ids = dict(image_token_id=IMG, vision_start_token_id=VSTART,
               object_token_id=OBJ)
    return (JQ.RefCfg(vision=JQ.RefVisionCfg(**vision),
                      text=JQ.RefTextCfg(**text), **ids),
            TQ.RefCfg(vision=TQ.RefVisionCfg(**vision),
                      text=TQ.RefTextCfg(**text), **ids))


def jax_params(jcfg, gh=8, gw=8, seed=0):
    """Flax init of the JAX RefModules (jitted: eager init dispatches
    op by op), as numpy leaves."""
    v = jcfg.vision
    mod = JRefModules(jcfg, gh, gw)
    init = jax.jit(lambda key, *a: mod.init(key, *a[:6], 4, a[6]))
    variables = init(
        jax.random.PRNGKey(seed),
        np.zeros((gh * gw, 3 * v.temporal_patch * v.patch ** 2),
                 np.float32),
        np.zeros((1, 32), np.int32), np.ones((1, 32), np.int32),
        np.zeros((3, 1, 32), np.int32), np.zeros((3, 4), np.float32),
        np.array([64.0, 64.0], np.float32), np.zeros((1, 3), np.int32))
    return jax.tree.map(np.asarray, variables["params"])


def port_model(params, tcfg, attn_impl="auto"):
    model = RefModules(tcfg, attn_impl=attn_impl,
                       lm_head="lm_head" in params)
    model.load_state_dict(from_jax_ref_params(params, tcfg), strict=True)
    return model.eval()


@dataclasses.dataclass
class Batch:
    patches: np.ndarray
    boxes: np.ndarray
    ori_wh: np.ndarray
    visual_start: int
    ids: np.ndarray          # joint (B, L)
    mask: np.ndarray
    pos: np.ndarray          # (3, B, L)
    obj: np.ndarray          # (B, N) joint positions
    prefix_ids: np.ndarray   # (1, P)
    prefix_mask: np.ndarray
    prefix_pos: np.ndarray   # (3, 1, P)
    suffix_ids: np.ndarray   # (B, S)
    suffix_mask: np.ndarray
    suffix_pos: np.ndarray   # (3, B, S)
    suffix_obj: np.ndarray   # (B, N) suffix-relative


def batch(seed=1, gh=8, gw=8, p_pad=24, s_pad=8, l_pad=None, n_obj=2,
          patch_dim=96):
    """Three queries of different lengths on one image, laid out as in
    tests/test_prefix_prefill.py: the joint rows and the same rows split
    at the end of the (padded) prefix."""
    rng = np.random.default_rng(seed)
    n_img = (gh // 2) * (gw // 2)
    patches = rng.standard_normal((gh * gw, patch_dim)).astype(np.float32)
    boxes = np.array([[4, 4, 60, 40], [10, 8, 90, 60], [0, 30, 96, 64]],
                     np.float32)[:n_obj]
    prefix_real = np.concatenate([np.array([1, 2, VSTART]),
                                  np.full(n_img, IMG), np.array([7])])
    p_real = len(prefix_real)
    sufs = [np.concatenate([np.array([9, 8, 5]), np.full(n_obj, OBJ),
                            np.array([2])]),
            np.concatenate([np.array([11]), np.full(n_obj, OBJ),
                            np.array([2])]),
            np.concatenate([np.array([4, 6, 10, 3]), np.full(n_obj, OBJ),
                            np.array([2])])]
    b = len(sufs)
    l = l_pad or p_real + s_pad          # >= p_real + s_pad
    out = dict(ids=np.zeros((b, l), np.int32),
               mask=np.zeros((b, l), np.int32),
               pos=np.zeros((3, b, l), np.int32),
               obj=np.zeros((b, n_obj), np.int32),
               suffix_ids=np.zeros((b, s_pad), np.int32),
               suffix_mask=np.zeros((b, s_pad), np.int32),
               suffix_pos=np.zeros((3, b, s_pad), np.int32),
               suffix_obj=np.zeros((b, n_obj), np.int32))
    for i, suf in enumerate(sufs):
        seq = np.concatenate([prefix_real, suf])
        out["ids"][i, :len(seq)] = seq
        out["mask"][i, :len(seq)] = 1
        pos = get_rope_index_single_image(
            np.pad(seq, (0, l - len(seq))), IMG, gh, gw, 2)
        out["pos"][:, i] = pos
        op = np.nonzero(seq == OBJ)[0]
        out["obj"][i] = op
        out["suffix_ids"][i, :len(suf)] = suf
        out["suffix_mask"][i, :len(suf)] = 1
        out["suffix_pos"][:, i] = pos[:, p_real:p_real + s_pad]
        out["suffix_obj"][i] = op - p_real
    prefix_ids = np.zeros((1, p_pad), np.int32)
    prefix_ids[0, :p_real] = prefix_real
    prefix_mask = np.zeros((1, p_pad), np.int32)
    prefix_mask[0, :p_real] = 1
    prefix_pos = np.zeros((3, 1, p_pad), np.int32)
    prefix_pos[:, 0, :p_real] = out["pos"][:, 0, :p_real]
    return Batch(patches=patches, boxes=boxes,
                 ori_wh=np.array([96.0, 64.0], np.float32),
                 visual_start=3, prefix_ids=prefix_ids,
                 prefix_mask=prefix_mask, prefix_pos=prefix_pos, **out)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for a test module that imports this fixture:
    the models are tiny, and with several test workers on the host
    torch's default thread team only contends."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
