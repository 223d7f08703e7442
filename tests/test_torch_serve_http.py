"""The port's HTTP serving front-end (`wedetect_tpu_torch/models/
serve_http.py`, `cli/serve_http.py`) and the serve_ref CLI, on the CPU.

GenService (a long-lived engine thread, concurrent submits) emits what
RefScorer.generate_batch emits for the same requests, and that equals
the JAX package's generate_batch; the HTTP stack serves the same texts
(data-URI images, per-request caps, 400 and 404), streams SSE events
whose deltas add up to the final text, answers 429 with Retry-After
past max_queue, and an engine-side raise fails the pool's requests
fast, is reported in stats, and the service recovers.
"""

import base64
import io
import json
import queue
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

from torch_ref_util import FakeTok, cfgs, jax_params, port_model
from torch_ref_util import one_torch_thread  # noqa: F401 (autouse)
from wedetect_tpu.models.ref_api import RefScorer as JRefScorer
from wedetect_tpu_torch.cli.serve_http import make_handler
from wedetect_tpu_torch.data import vision_process as vp
from wedetect_tpu_torch.models import serve as serve_mod
from wedetect_tpu_torch.models.ref_api import RefScorer
from wedetect_tpu_torch.models.serve_http import GenService, Overloaded

EOS, PAD = 127, 126
PROMPTS = ["find the dog", "a red box", "cat?", "blue thing"]


class DecTok(FakeTok):
    def decode(self, ids):
        return " ".join(str(i) for i in ids)


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = cfgs()
    params = jax_params(jcfg)
    return jcfg, tcfg, params


def _fake_patches(img, **kw):
    rng = np.random.default_rng(1)
    return rng.standard_normal((64, 96)).astype(np.float32), 8, 8


def _scorer(tcfg, params):
    return RefScorer(cfg=tcfg, model=port_model(params, tcfg),
                     tokenizer=DecTok(), device_patchify=False, device="cpu")


def _service(tcfg, params, **kw):
    return GenService(_scorer(tcfg, params), **{
        "slots": 2, "chunk": 2, "max_new": 6, "prompt_buckets": (64,),
        "max_pools": 1, "eos_token_id": EOS, "pad_token_id": PAD, **kw})


def _data_uri():
    from PIL import Image

    buf = io.BytesIO()
    Image.new("RGB", (64, 64), (30, 60, 90)).save(buf, format="PNG")
    return "data:image/png;base64," + base64.b64encode(
        buf.getvalue()).decode()


def _post(url, obj, timeout=120):
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), r.headers
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers


def _want(tcfg, params, img, prompts):
    return _scorer(tcfg, params).generate_batch(
        [(img, p) for p in prompts], max_new_tokens=6, eos_token_id=EOS,
        pad_token_id=PAD, slots=2, chunk=2)


class _PumpGate:
    """Holds the first GenServer.pump call until released, pinning the
    engine thread inside a pool turn."""

    def __init__(self, monkeypatch):
        orig = serve_mod.GenServer.pump
        self.entered, self.release = threading.Event(), threading.Event()
        armed = [True]

        def gated(srv, pending=None):
            if armed[0]:
                armed[0] = False
                self.entered.set()
                self.release.wait(120)
            return orig(srv, pending)

        monkeypatch.setattr(serve_mod.GenServer, "pump", gated)


def test_gen_service_matches_generate_batch_and_jax(tiny, monkeypatch):
    jcfg, tcfg, params = tiny
    import wedetect_tpu.data.vision_process as jvp

    monkeypatch.setattr(vp, "image_to_patches", _fake_patches)
    monkeypatch.setattr(jvp, "image_to_patches", _fake_patches)
    img = np.zeros((64, 64, 3), np.uint8)
    want = _want(tcfg, params, img, PROMPTS)
    jax_texts = JRefScorer(
        cfg=jcfg, params=params, tokenizer=DecTok(),
        device_patchify=False).generate_batch(
        [(img, p) for p in PROMPTS], max_new_tokens=6, eos_token_id=EOS,
        pad_token_id=PAD, slots=2, chunk=2)
    assert want == jax_texts
    svc = _service(tcfg, params)
    try:
        futs = [svc.submit(img, p) for p in PROMPTS]
        for f in futs:
            assert f.wait(120) and f.error is None, f.error
        assert [f.text for f in futs] == want
        assert svc.stats()["served"] == len(PROMPTS)
    finally:
        svc.shutdown()


def test_http_end_to_end_sse_and_429(tiny, monkeypatch):
    _, tcfg, params = tiny
    monkeypatch.setattr(vp, "image_to_patches", _fake_patches)
    img = np.zeros((64, 64, 3), np.uint8)
    want = _want(tcfg, params, img, PROMPTS[:3])
    svc = _service(tcfg, params, max_queue=1)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                make_handler(svc, vp.fetch_image, 120.0))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_port}"
    uri = _data_uri()
    try:
        for i, p in enumerate(PROMPTS[:3]):
            code, obj, _ = _post(f"{base}/v1/generate",
                                 {"prompt": p, "image": uri})
            assert code == 200 and obj["text"] == want[i], obj
        code, capped, _ = _post(f"{base}/v1/generate",
                                {"prompt": PROMPTS[0], "image": uri,
                                 "max_new_tokens": 2})
        assert code == 200 and capped["text"].split() == \
            want[0].split()[:2]
        assert _post(f"{base}/v1/generate", {"prompt": "hi",
                     "image": "/nonexistent.png"})[0] == 400
        assert _post(f"{base}/health", {})[0] == 404

        # SSE: the deltas add up to the final text, which equals the
        # non-streamed text
        req = urllib.request.Request(
            f"{base}/v1/generate", data=json.dumps(
                {"prompt": PROMPTS[1], "image": uri,
                 "stream": True}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            events = [json.loads(b[len("data: "):]) for b in
                      r.read().decode().split("\n\n")
                      if b.strip().startswith("data: ")]
        assert events[-1]["done"] and events[-1]["text"] == want[1]
        assert "".join(e["text_delta"] or "" for e in events) == want[1]

        # 429 with Retry-After once the admission queue is full: the
        # engine pinned in a pump, one request waits in the queue
        gate = _PumpGate(monkeypatch)
        first = svc.submit(img, PROMPTS[0])
        assert gate.entered.wait(120)
        queued = {}
        t = threading.Thread(target=lambda: queued.update(r=_post(
            f"{base}/v1/generate", {"prompt": "cat?", "image": uri})))
        t.start()
        t0 = time.monotonic()
        while svc._inbox.qsize() < 1:
            assert time.monotonic() - t0 < 60, "request never queued"
            time.sleep(0.01)
        code, obj, headers = _post(f"{base}/v1/generate",
                                   {"prompt": "cat?", "image": uri})
        assert code == 429 and obj["error"]
        assert headers["Retry-After"] == "1"
        gate.release.set()
        t.join(120)
        assert queued["r"][0] == 200
        assert first.wait(120) and first.error is None
    finally:
        httpd.shutdown()
        svc.shutdown()


def test_backpressure_overloaded(tiny, monkeypatch):
    _, tcfg, params = tiny
    monkeypatch.setattr(vp, "image_to_patches", _fake_patches)
    img = np.zeros((64, 64, 3), np.uint8)
    svc = _service(tcfg, params, max_queue=1)
    gate = _PumpGate(monkeypatch)
    try:
        first = svc.submit(img, PROMPTS[0], stream=True)
        assert gate.entered.wait(120)
        svc.submit(img, PROMPTS[1])
        with pytest.raises(Overloaded):
            svc.submit(img, PROMPTS[2])
        gate.release.set()
        chunks = []
        while True:
            item = first.stream_queue.get(timeout=120)
            if item is None:
                break
            chunks.extend(item)
        assert chunks == [int(t) for t in first.tokens]
    except queue.Empty:
        pytest.fail("stream stalled")
    finally:
        gate.release.set()
        svc.shutdown()


def test_engine_failure_fails_fast_and_recovers(tiny, monkeypatch):
    _, tcfg, params = tiny
    monkeypatch.setattr(vp, "image_to_patches", _fake_patches)
    img = np.zeros((64, 64, 3), np.uint8)
    svc = _service(tcfg, params)
    orig = serve_mod.GenServer.pump

    def boom(self, pending=None):
        raise RuntimeError("injected device fault")

    try:
        monkeypatch.setattr(serve_mod.GenServer, "pump", boom)
        futs = [svc.submit(img, p) for p in PROMPTS[:2]]
        for f in futs:
            assert f.wait(60), "request hung"
            assert "engine failure" in f.error
            assert "injected device fault" in f.error
        stats = svc.stats()
        assert stats["degraded"] is True
        assert "injected device fault" in stats["incidents"][-1]["error"]
        monkeypatch.setattr(serve_mod.GenServer, "pump", orig)
        res = svc.submit(img, PROMPTS[0])
        assert res.wait(120) and res.error is None and res.text
    finally:
        svc.shutdown()
    with pytest.raises(RuntimeError, match="stopped"):
        svc.submit(img, "after shutdown")


def test_serve_ref_cli_on_cpu(tmp_path, capsys):
    """cli/serve_ref over a JSONL request file with a miniature random
    Ref on the CPU: one line a request, in order, the same texts with
    and without piggyback admission."""
    from PIL import Image

    from wedetect_tpu_torch.cli import serve_ref

    img = tmp_path / "a.png"
    Image.new("RGB", (64, 96), (10, 200, 30)).save(img)
    reqs = tmp_path / "reqs.jsonl"
    reqs.write_text("".join(json.dumps({"image": str(img), "prompt": p})
                            + "\n" for p in PROMPTS[:3]))
    base = ["--random-init", "--device", "cpu", "--f32", "--requests",
            str(reqs), "--max_new_tokens", "4", "--slots", "2", "--chunk",
            "2"]
    out = tmp_path / "out.jsonl"
    texts = serve_ref.main(base + ["--out", str(out)])
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    assert [x["id"] for x in lines] == [0, 1, 2]
    assert [x["text"] for x in lines] == texts
    assert serve_ref.main(base + ["--piggyback"]) == texts
    assert "requests in" in capsys.readouterr().err
