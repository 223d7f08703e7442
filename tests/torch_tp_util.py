"""What the tensor-parallel tests share with their gloo ranks (no JAX
here: the ranks import this module): tests/test_tp.py's configuration,
the serving modes (float, and with a quantized decode tree), and one
GenServer run over a list of requests."""

import numpy as np

GH = GW = 8
P, G = 48, 5
EOS, PAD = 99, 0
WARPED = dict(temperature=0.8, top_k=30, top_p=0.9)
SERVE_MODES = {"greedy": {}, "warped": WARPED, "kv8": dict(kv_bits=8),
               "piggyback": dict(piggyback=True),
               "batch_admit": dict(batch_admit=True)}
# GenServer modes with an int8 / int4 decode tree ("bits"), and with the
# int8 prefill ("prefill8": RefCfg.quant_int8 on the admissions)
QUANT_SERVE_MODES = {
    "int8": dict(bits=8), "int4": dict(bits=4),
    "int8_kv8": dict(bits=8, kv_bits=8),
    "int8_batch_admit": dict(bits=8, batch_admit=True),
    "int4_piggyback": dict(bits=4, piggyback=True),
    "int8_prefill8": dict(bits=8, prefill8=True, temperature=0.8, top_k=30,
                          top_p=0.9)}
SPEC_MODES = {"plain": {}, "force_reject": dict(force_reject=True),
              "int8": dict(bits=8)}
SPEC_NEW, SPEC_K = 12, 4


def tp_cfg(pkg):
    """tests/test_tp.py's `_tp_cfg`, in `pkg`'s RefCfg (either package's
    nn/qwen3vl)."""
    return pkg.RefCfg(
        vision=pkg.RefVisionCfg(depth=2, hidden=32, heads=4,
                                intermediate=64, patch=4, temporal_patch=2,
                                merge=2, out_hidden=48, num_pos_emb=64,
                                deepstack_idx=(0, 1)),
        text=pkg.RefTextCfg(vocab_size=256, hidden=48, layers=2, heads=8,
                            kv_heads=4, head_dim=16, intermediate=96,
                            rope_theta=1000.0, mrope_section=(4, 2, 2)),
        image_token_id=120, vision_start_token_id=122,
        object_token_id=123)


def serve(cls, cfg, params, reqs, stats=None, **kw):
    """{request index: tokens} of one GenServer (either package's) drained
    over reqs, request r with seed 40 + r, as tests/test_tp.py runs it;
    the server's stats go into `stats` where given."""
    srv = cls(cfg, GH, GW, params, slots=2, prompt_len=P, max_new=G,
              chunk=2, eos_id=EOS, pad_id=PAD, **kw)
    rids = {srv.submit(q["patches"], q["ids"], q["mask"], q["pos"], 1,
                       int(q["nxt"]), seed=40 + r): r
            for r, q in enumerate(reqs)}
    out = {rids[rid]: list(map(int, np.asarray(t)))
           for rid, t in srv.run().items()}
    if stats is not None:
        stats.update(srv.stats)
    return out
