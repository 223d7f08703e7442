"""HTTP front-end for the continuous-batching generation engine.

Port of `wedetect_tpu/models/serve_http.py` (host code): it turns
`models/serve.GenServer` into a long-lived service (the reference ships
no serving surface: its generation twin inherits HF `.generate`,
wedetect_ref/models/qwen3vl_grounding.py:311-379).

- One engine thread owns the card: every prefill, decode chunk and
  token readback runs on it, through `GenServer.pump()`, the pipelined
  one-turn scheduler. Handler threads do host work only (decode the
  image, tokenize, assemble the padded prompt with
  `RefScorer._build_gen_prompt`, enqueue) and block on a per-request
  event.
- Pools by shape: one GenServer per (image grid, visual_start, prompt
  bucket), created on demand and capped at `max_pools`; each pool holds
  a slots x (P + max_new) KV pool on the card. Idle pools are evicted
  LRU at the cap; when every pool is busy, admissions for a new key
  wait until one goes idle.
- No wedge: an engine-side raise fails that pool's in-flight requests
  with an error, records the incident (`degraded` / `incidents` in
  stats), drops the pool, and a fresh one is built on the next
  admission for its key.
- Streaming and backpressure: `submit(stream=True)` delivers token-id
  lists per decode chunk through `Result.stream_queue` (the
  `GenServer.on_tokens` hook); `max_queue` bounds the admission queue
  and raises `Overloaded` beyond it (HTTP 429 upstream).

Sampling (temperature, top_k, top_p, per-request seeds) and the
quantized decode of the scorer (`RefScorer.quantize_decode`) pass
through to the GenServer unchanged. `cli/serve_http.py` documents the
JSON protocol.
"""

from __future__ import annotations

import queue
import threading
import time

import numpy as np

__all__ = ["GenService", "Result", "Overloaded"]


class Overloaded(RuntimeError):
    """Raised by submit() when the admission queue is at max_queue —
    the HTTP front-end maps it to 429 + Retry-After (backpressure
    instead of unbounded memory/latency growth under a client burst)."""


class Result:
    """Completion handle returned by GenService.submit().

    ``id`` is the request's stable identifier (stamped at submit).
    With ``stream=True``, ``stream_queue`` receives lists of newly
    generated token ids as each decode chunk lands (then ``None`` as
    the end-of-stream sentinel, after which tokens/text/error are
    final)."""

    def __init__(self, rid: int, stream: bool = False):
        self.id = rid
        self._event = threading.Event()
        self.stream_queue: queue.Queue | None = \
            queue.Queue() if stream else None
        self.tokens: np.ndarray | None = None
        self.text: str | None = None
        self.error: str | None = None
        self._n_streamed = 0

    def wait(self, timeout: float | None = None) -> bool:
        return self._event.wait(timeout)

    def _resolve(self, tokens, text):
        self.tokens, self.text = tokens, text
        self._event.set()
        if self.stream_queue is not None:
            self.stream_queue.put(None)

    def _fail(self, error: str):
        self.error = error
        self._event.set()
        if self.stream_queue is not None:
            self.stream_queue.put(None)

    def _stream(self, toks, cap: int):
        if self.stream_queue is None:
            return
        room = cap - self._n_streamed
        if room <= 0:
            return
        toks = list(toks)[:room]
        self._n_streamed += len(toks)
        if toks:
            self.stream_queue.put(toks)


class _Pool:
    """One GenServer + its in-flight bookkeeping."""

    def __init__(self, srv):
        self.srv = srv
        self.pending = None          # pump() pipeline carry
        self.results = {}            # rid -> (Result, max_new cap)
        self.last_used = time.monotonic()

    @property
    def active(self):
        return self.srv.busy or self.pending is not None


class GenService:
    """Thread-safe generation service over RefScorer + GenServer.

    ``submit()`` may be called from any thread (the HTTP handlers);
    all device work runs on the internal engine thread. ``scorer``
    supplies the tokenizer, vision preprocessing, grid buckets,
    dtype, and (optional) weight-only decode tree."""

    def __init__(self, scorer, *, slots: int = 8, chunk: int = 8,
                 max_new: int = 128,
                 prompt_buckets=(256, 384, 512, 1024, 2048),
                 max_pools: int = 2,
                 max_queue: int = 0,
                 eos_token_id: int = 151645,
                 pad_token_id: int = 151643,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, kv_bits: int = 16):
        if getattr(scorer.model, "tp", None) is not None:
            raise NotImplementedError(
                "the HTTP service under tensor parallelism is not ported "
                "(ROADMAP.md §1 item 13)")
        self.scorer = scorer
        self.kv_bits = kv_bits   # 8 = int8 KV pools (models/serve)
        self.slots, self.chunk, self.max_new = slots, chunk, max_new
        self.prompt_buckets = tuple(sorted(prompt_buckets))
        self.max_pools = max_pools
        self.max_queue = max_queue   # 0 = unbounded admission queue
        self.eos_id, self.pad_id = eos_token_id, pad_token_id
        self.sampling = (temperature, top_k, top_p)
        scorer.decode_tree()            # build a quantized tree once
        self._inbox: queue.Queue = queue.Queue()
        self._deferred: list = []    # items waiting for a pool slot
        self._pools: dict = {}       # (gh, gw, vs, p_pad) -> _Pool
        self._incidents: list = []   # (time, pool key str, error str)
        self._stop = threading.Event()
        self._served = 0
        self._next_rid = 0
        self._rid_lock = threading.Lock()
        self._thread = threading.Thread(target=self._loop,
                                        name="gen-engine", daemon=True)
        self._thread.start()

    # ---------------------------------------------------- client side

    def submit(self, image, prompt: str, max_new_tokens: int = 0,
               seed: int | None = None, stream: bool = False) -> Result:
        """Host-only prompt assembly + enqueue; returns a Result the
        caller waits on. Raises ValueError when the prompt exceeds the
        largest bucket (the engine's compiled shapes are static) and
        Overloaded when the admission queue is at ``max_queue``. With
        ``stream=True`` the Result's stream_queue receives token-id
        lists per decode chunk (None = end of stream)."""
        if self._stop.is_set():
            raise RuntimeError("service stopped")
        # count deferred items too: the engine moves pool-capped
        # admissions inbox -> _deferred, which would otherwise free
        # inbox space and let a mixed-key burst grow past the cap
        if self.max_queue and (self._inbox.qsize()
                               + len(self._deferred)) >= self.max_queue:
            raise Overloaded(
                f"admission queue at max_queue={self.max_queue}")
        built = self.scorer._build_gen_prompt(
            np.asarray(image), prompt, self.pad_id)
        patches, gh, gw, ids, mask, pos, vs, w, h = built
        p_real = int(mask.sum())
        p_pad = next((b for b in self.prompt_buckets if b >= p_real),
                     None)
        if p_pad is None:
            raise ValueError(
                f"prompt is {p_real} tokens; largest bucket is "
                f"{self.prompt_buckets[-1]}")
        pad = p_pad - len(ids)
        if pad > 0:
            ids = np.pad(ids, (0, pad), constant_values=self.pad_id)
            mask = np.pad(mask, (0, pad))
            pos = np.pad(pos, ((0, 0), (0, pad)))
        else:
            ids, mask, pos = ids[:p_pad], mask[:p_pad], pos[:, :p_pad]
        cap = min(max_new_tokens, self.max_new) if max_new_tokens \
            else self.max_new
        with self._rid_lock:
            rid = self._next_rid
            self._next_rid += 1
        res = Result(rid, stream=stream)
        self._inbox.put(((gh, gw, vs, p_pad),
                         (patches, ids, mask, pos, vs, w, h),
                         cap, seed, res))
        return res

    def generate(self, image, prompt: str, max_new_tokens: int = 0,
                 seed: int | None = None,
                 timeout: float | None = None):
        """Blocking convenience wrapper: submit + wait + return text."""
        res = self.submit(image, prompt, max_new_tokens, seed)
        if not res.wait(timeout):
            raise TimeoutError("generation timed out")
        if res.error:
            raise RuntimeError(res.error)
        return res.text

    def stats(self) -> dict:
        pools = {
            f"{gh}x{gw}/P{p_pad}": dict(srv.stats, active=pool.active)
            for (gh, gw, _vs, p_pad), pool in list(self._pools.items())
            for srv in (pool.srv,)}
        out = {"served": self._served, "queued": self._inbox.qsize(),
               "deferred": len(self._deferred), "pools": pools}
        if self._incidents:
            # engine-side failures that dropped a pool (its in-flight
            # requests were failed, the pool rebuilds on next demand)
            out["degraded"] = True
            out["incidents"] = [
                {"time": t, "pool": k, "error": e}
                for t, k, e in self._incidents[-8:]]
        return out

    def shutdown(self, timeout: float = 30.0):
        """Stop the engine thread after draining in-flight work."""
        self._stop.set()
        self._inbox.put(None)                  # wake the idle wait
        self._thread.join(timeout)

    # ---------------------------------------------------- engine side

    def _get_pool(self, key) -> _Pool | None:
        """Existing pool for ``key``, or a new one if the cap allows
        (evicting an idle LRU pool when needed). Returns None when the
        cap is hit and every resident pool is active — the caller
        DEFERS the admission instead of allocating past the cap (each
        pool preallocates a slots x (P + max_new) KV cache; creating
        pools past max_pools under sustained mixed-key traffic would
        grow card memory unbounded)."""
        pool = self._pools.get(key)
        if pool is None:
            if len(self._pools) >= self.max_pools:
                idle = [(p.last_used, k) for k, p in
                        self._pools.items() if not p.active]
                if not idle:
                    return None                # defer: all pools busy
                del self._pools[min(idle)[1]]  # LRU-evict an idle pool
            from wedetect_tpu_torch.models.serve import GenServer

            gh, gw, _vs, p_pad = key
            t, k, p = self.sampling
            pool = _Pool(GenServer(
                self.scorer.cfg, gh, gw, self.scorer.model,
                slots=self.slots, prompt_len=p_pad,
                max_new=self.max_new, chunk=self.chunk,
                eos_id=self.eos_id, pad_id=self.pad_id,
                decode_params=self.scorer.decode_tree(),
                temperature=t, top_k=k, top_p=p,
                kv_bits=self.kv_bits))
            pool.srv.on_tokens = \
                lambda rid, toks, _pool=pool: self._on_tokens(
                    _pool, rid, toks)
            self._pools[key] = pool
        return pool

    def _on_tokens(self, pool: _Pool, rid, toks):
        """GenServer streaming hook (engine thread): route a chunk's
        newly collected tokens to the request's stream queue."""
        res, cap = pool.results.get(rid, (None, None))
        if res is not None:
            res._stream(toks, cap)

    def _admit(self, item) -> bool:
        """Admit one inbox item into its pool's engine queue. Returns
        False when the admission must be deferred (pool cap hit with
        every pool active); True when the item was consumed (admitted
        or failed)."""
        key, (patches, ids, mask, pos, vs, w, h), cap, seed, res = item
        try:
            pool = self._get_pool(key)
            if pool is None:
                return False
            srv = pool.srv
            next_pos0 = int(pos[:, mask.astype(bool)].max()) + 1
            rid = srv.submit(
                patches, ids, mask, pos, vs, next_pos0,
                boxes_xyxy=np.array([[0, 0, w, h]], np.float32),
                ori_wh=np.array([w, h], np.float32), seed=seed,
                max_new=cap)
            pool.results[rid] = (res, cap)
            pool.last_used = time.monotonic()
        except Exception as e:                  # resolve, don't wedge
            res._fail(f"{type(e).__name__}: {e}")
        return True

    def _resolve(self, pool: _Pool, finished: dict):
        tok = self.scorer.tokenizer
        for rid, toks in finished.items():
            res, cap = pool.results.pop(rid, (None, None))
            if res is None:
                continue
            toks = np.asarray(toks[:cap], np.int32)
            text = (tok.decode([int(t) for t in toks])
                    if hasattr(tok, "decode") else None)
            res._resolve(toks, text)
            self._served += 1

    def _loop(self):
        while True:
            busy = any(p.active for p in self._pools.values()) \
                or bool(self._deferred)
            try:
                # block only when fully idle; otherwise just drain
                item = self._inbox.get(
                    block=not busy, timeout=None if busy else 0.25)
                while True:
                    if item is not None and not self._admit(item):
                        self._deferred.append(item)
                    item = self._inbox.get_nowait()
            except queue.Empty:
                pass
            if self._stop.is_set() and self._inbox.empty() and \
                    not self._deferred and \
                    not any(p.active for p in self._pools.values()):
                return
            for key, pool in list(self._pools.items()):
                if not pool.active:
                    continue
                try:
                    pool.pending, finished = pool.srv.pump(pool.pending)
                except Exception as e:  # noqa: BLE001 — fail visibly,
                    # never wedge: one engine-side raise fails every
                    # in-flight request of THIS pool, records the
                    # incident for /health, and drops the pool (a
                    # fresh one rebuilds on the next admission for the
                    # key); other pools and future requests proceed.
                    err = f"engine failure: {type(e).__name__}: {e}"
                    for res, _cap in pool.results.values():
                        res._fail(err)
                    pool.results.clear()
                    if self._pools.get(key) is pool:
                        del self._pools[key]
                    gh, gw, _vs, p_pad = key
                    self._incidents.append(
                        (time.time(), f"{gh}x{gw}/P{p_pad}", str(e)))
                    continue
                self._resolve(pool, finished)
            if self._deferred:
                # retry pool-capped admissions — a pool may have gone
                # idle (evictable) since the last turn
                self._deferred = [it for it in self._deferred
                                  if not self._admit(it)]
