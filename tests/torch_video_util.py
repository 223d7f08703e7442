"""Shared pieces of the port's video tests: the tiny Ref of
tests/test_video.py (ViT depth 2, hidden 32, patch 4, temporal_patch 2,
merge 2; decoder 2 layers, hidden 48) for both packages, its JAX params
carried into the port, and a video prompt laid out as one contiguous
video span."""

import dataclasses

import numpy as np

import jax

from wedetect_tpu.models.ref import RefModules as JRefModules
from wedetect_tpu.nn import qwen3vl as JQ
from wedetect_tpu.nn.qwen3vl import get_rope_index_single_video
from wedetect_tpu_torch.nn import qwen3vl as TQ

IMG, VID, VSTART, OBJ = 120, 121, 122, 123


class FakeTok:
    """One small id a character (at most 8 a call); decode joins ids."""

    pad_token_id = 0

    def encode(self, text, add_special_tokens=False):
        return [(ord(ch) % 80) + 1 for ch in text][:8]

    def decode(self, ids):
        return " ".join(str(int(i)) for i in ids)


def video_cfgs(head_dim=16, vocab=128):
    """(JAX RefCfg, port RefCfg) of the tiny video Ref."""
    vision = dict(depth=2, hidden=32, heads=4, intermediate=64, patch=4,
                  temporal_patch=2, merge=2, out_hidden=48, num_pos_emb=64,
                  deepstack_idx=(0, 1))
    section = {16: (4, 2, 2), 128: (24, 20, 20)}[head_dim]
    text = dict(vocab_size=vocab, hidden=48, layers=2, heads=4, kv_heads=2,
                head_dim=head_dim, intermediate=96, rope_theta=1000.0,
                mrope_section=section)
    ids = dict(image_token_id=IMG, video_token_id=VID,
               vision_start_token_id=VSTART, object_token_id=OBJ)
    return (JQ.RefCfg(vision=JQ.RefVisionCfg(**vision),
                      text=JQ.RefTextCfg(**text), **ids),
            TQ.RefCfg(vision=TQ.RefVisionCfg(**vision),
                      text=TQ.RefTextCfg(**text), **ids))


def video_params(jcfg, seed=0, gt=2, gh=8, gw=12):
    """Flax init of the JAX RefModules at a video grid (jitted), as
    numpy leaves; the tree does not depend on the grid."""
    v = jcfg.vision
    mod = JRefModules(jcfg, gh, gw, grid_t=gt)
    n_vid = gt * (gh // v.merge) * (gw // v.merge)
    ids = np.concatenate([[1, VSTART], np.full(n_vid, VID), [5, 6]])
    init = jax.jit(lambda key, *a: mod.init(key, *a[:6], 2, a[6]))
    variables = init(
        jax.random.PRNGKey(seed),
        np.zeros((gt * gh * gw, 3 * v.temporal_patch * v.patch ** 2),
                 np.float32),
        ids[None].astype(np.int32), np.ones((1, len(ids)), np.int32),
        np.zeros((3, 1, len(ids)), np.int32),
        np.array([[0, 0, 48, 32]], np.float32),
        np.array([48.0, 32.0], np.float32), np.zeros((1, 1), np.int32))
    return jax.tree.map(np.asarray, variables["params"])


@dataclasses.dataclass
class VideoBatch:
    patches: np.ndarray      # (gt * gh * gw, 3 * 2 * 4 * 4)
    gt: int
    gh: int
    gw: int
    ids: np.ndarray          # (B, L)
    mask: np.ndarray
    pos: np.ndarray          # (3, B, L)
    visual_start: int
    boxes: np.ndarray        # (N, 4)
    ori_wh: np.ndarray
    obj: np.ndarray          # (B, N): -1 without objects

    def swap_groups(self):
        """The patches with temporal groups 0 and 1 swapped."""
        n = self.gh * self.gw
        p = self.patches.copy()
        p[:n], p[n:2 * n] = self.patches[n:2 * n], self.patches[:n]
        return p


def video_batch(seed=1, gt=2, gh=8, gw=12, l_pad=None, objects=False):
    """Two rows of different lengths sharing one video span at offset 2.
    With `objects`, each row's text holds two <object> slots whose boxes
    read the RoI pyramid (the first temporal group); without, the slots
    are -1 (a caption-only sample)."""
    rng = np.random.default_rng(seed)
    n_vid = gt * (gh // 2) * (gw // 2)
    patches = rng.standard_normal((gt * gh * gw, 96)).astype(np.float32)
    head = np.concatenate([[1, VSTART], np.full(n_vid, VID)])
    tails = [np.array([7, 9, 11, 3]), np.array([4, 6])]
    if objects:
        tails = [np.concatenate([t, [OBJ, OBJ, 2]]) for t in tails]
    seqs = [np.concatenate([head, t]) for t in tails]
    l = l_pad or max(len(s) for s in seqs)
    b = len(seqs)
    ids = np.zeros((b, l), np.int32)
    mask = np.zeros((b, l), np.int32)
    pos = np.zeros((3, b, l), np.int32)
    obj = np.full((b, 2 if objects else 1), -1, np.int32)
    for i, s in enumerate(seqs):
        ids[i, :len(s)] = s
        mask[i, :len(s)] = 1
        pos[:, i] = get_rope_index_single_video(ids[i], VID, gt, gh, gw, 2)
        if objects:
            obj[i] = np.nonzero(s == OBJ)[0]
    boxes = np.array([[2, 3, 30, 20], [10, 4, 46, 30]], np.float32)
    return VideoBatch(patches=patches, gt=gt, gh=gh, gw=gw, ids=ids,
                      mask=mask, pos=pos, visual_start=2,
                      boxes=boxes if objects else boxes[:1],
                      ori_wh=np.array([gw * 4.0, gh * 4.0], np.float32),
                      obj=obj)
