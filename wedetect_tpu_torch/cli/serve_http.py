"""Long-lived HTTP generation server over the continuous-batching
engine (models/serve_http.GenService -> models/serve.GenServer).

    python -m wedetect_tpu_torch.cli.serve_http \
        --ref_checkpoint <hf-dir> [--host 127.0.0.1 --port 8000] \
        [--slots 8 --chunk 8 --max_new_tokens 128] \
        [--int8-decode | --int4-decode] [--temperature 0.7 ...]

Port of `wedetect_tpu/cli/serve_http.py`. API:
    POST /v1/generate
        {"prompt": str,                      # user text
         "image": str,                       # path | http(s) URL |
                                             # data:image;base64 URI
         "max_new_tokens": int?,             # <= server --max_new_tokens
         "seed": int?,                       # sampling stream (T > 0)
         "stream": bool?}                    # SSE token streaming
        -> {"text": str, "tokens": [int], "id": int}
        stream=true -> text/event-stream (chunked): one
        `data: {"tokens": [...], "text_delta": str?}` event per decode
        chunk, then `data: {"done": true, "text", "tokens", "id"}`.
        Concatenated text_delta values equal the final "text" (deltas
        are emitted only while the running decode is a byte-prefix of
        the final text; held-back bytes arrive in the last delta).
        429 + Retry-After when the admission queue is at --max-queue.
    GET /health
        -> {"ok": true, "served": N, "queued": N, "deferred": N,
            "pools": {...}, "degraded": bool?, "incidents": [...]?}

Handler threads do host work only (image decode, tokenize, pad); every
call on the card runs on GenService's single engine thread.
--random-init serves a miniature random Ref with a stub tokenizer (a
smoke run); --device cpu runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import queue
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="WeDetect-Ref HTTP generation server")
    p.add_argument("--ref_checkpoint", default="")
    p.add_argument("--random-init", action="store_true",
                   help="a miniature random Ref (smoke run)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max_new_tokens", type=int, default=128,
                   help="per-pool decode capacity; per-request "
                        "max_new_tokens can only lower it")
    p.add_argument("--slots", type=int, default=8)
    p.add_argument("--chunk", type=int, default=8,
                   help="decode steps a dispatch (tokens a slot between "
                        "admissions)")
    p.add_argument("--prompt-buckets", default="256,384,512,1024,2048",
                   help="comma-separated padded prompt lengths "
                        "(128 multiples: the kernels tile the admission "
                        "prefill); one engine per (grid, prompt) bucket")
    p.add_argument("--max-pools", type=int, default=2,
                   help="max resident engines (each holds a "
                        "slots x (P + max_new) KV pool on the card); when "
                        "all pools are active, admissions for new "
                        "keys are deferred, never allocated past the "
                        "cap")
    p.add_argument("--max-queue", type=int, default=256,
                   help="admission-queue cap: submits beyond it get "
                        "429 + Retry-After (0 = unbounded)")
    p.add_argument("--timeout", type=float, default=600.0,
                   help="per-request completion timeout (s)")
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--f32", dest="bf16", action="store_false")
    p.add_argument("--int8-decode", action="store_true",
                   help="weight-only int8 decode (models/quant)")
    p.add_argument("--int8-kv", action="store_true",
                   help="int8 KV cache pools (models/serve kv_bits=8):"
                        " ~0.52x the KV pool; lossy like weight-only "
                        "int8")
    p.add_argument("--int4-decode", action="store_true",
                   help="weight-only packed-int4 decode (models/"
                        "quant; lossier — validate per checkpoint)")
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top_k", type=int, default=0)
    p.add_argument("--top_p", type=float, default=1.0)
    return p.parse_args(argv)


def make_handler(service, fetch_image, timeout: float):
    from wedetect_tpu_torch.models.serve_http import Overloaded

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *a):       # stderr, not stdout
            sys.stderr.write("# http: " + fmt % a + "\n")

        def _json(self, code: int, obj, headers=()):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path in ("/health", "/"):
                return self._json(200, dict(ok=True, **service.stats()))
            return self._json(404, {"error": "not found"})

        # ------------------------------------------ SSE streaming
        def _chunk(self, data: bytes):
            """One HTTP/1.1 chunked-transfer frame."""
            self.wfile.write(f"{len(data):X}\r\n".encode()
                             + data + b"\r\n")

        def _event(self, obj):
            self._chunk(b"data: " + json.dumps(obj).encode() + b"\n\n")

        def _stream_response(self, res):
            """Drain res.stream_queue into SSE events. text_delta is
            emitted only while decode(prefix-tokens) stays a byte-
            prefix of the growing text (BPE can retro-edit bytes at
            token boundaries); held-back bytes land in the final
            delta, so the concatenation of every text_delta equals
            the final text byte-for-byte."""
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            tok = getattr(service.scorer, "tokenizer", None)
            dec = tok.decode if hasattr(tok, "decode") else None
            toks, sent = [], ""
            deadline = time.monotonic() + timeout
            while True:
                try:
                    item = res.stream_queue.get(
                        timeout=max(0.0, deadline - time.monotonic()))
                except queue.Empty:
                    self._event({"error": "timed out"})
                    break
                if item is None:               # end of stream
                    if res.error:
                        self._event({"error": res.error})
                        break
                    delta = res.text[len(sent):] \
                        if res.text is not None \
                        and res.text.startswith(sent) else None
                    self._event({
                        "done": True, "text": res.text,
                        "text_delta": delta,
                        "tokens": [int(t) for t in res.tokens],
                        "id": res.id})
                    break
                toks.extend(int(t) for t in item)
                delta = None
                if dec is not None:
                    full = dec(toks)
                    if full.startswith(sent):
                        delta = full[len(sent):]
                        sent = full
                self._event({"tokens": [int(t) for t in item],
                             "text_delta": delta})
            self._chunk(b"")                   # terminal 0-chunk
            self.close_connection = True

        def do_POST(self):
            if self.path not in ("/v1/generate", "/generate"):
                return self._json(404, {"error": "not found"})
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                prompt = req["prompt"]
                stream = bool(req.get("stream", False))
                image = fetch_image(req["image"])
            except Exception as e:
                return self._json(400, {"error": f"bad request: {e}"})
            try:
                res = service.submit(
                    image, prompt,
                    max_new_tokens=int(req.get("max_new_tokens", 0)),
                    seed=req.get("seed"), stream=stream)
            except Overloaded as e:            # backpressure
                return self._json(429, {"error": str(e)},
                                  headers=(("Retry-After", "1"),))
            except ValueError as e:            # prompt > largest bucket
                return self._json(413, {"error": str(e)})
            if stream:
                return self._stream_response(res)
            if not res.wait(timeout):
                return self._json(504, {"error": "timed out"})
            if res.error:
                return self._json(500, {"error": res.error})
            return self._json(200, {
                "text": res.text,
                "tokens": [int(t) for t in res.tokens],
                "id": res.id})

    return Handler


def build_service(args):
    from wedetect_tpu_torch.cli.serve_ref import load_scorer, special_ids
    from wedetect_tpu_torch.models.serve_http import GenService

    scorer, tok = load_scorer(args)
    eos, pad = special_ids(tok)
    return GenService(
        scorer, slots=args.slots, chunk=args.chunk,
        max_new=args.max_new_tokens,
        prompt_buckets=tuple(int(b) for b in
                             args.prompt_buckets.split(",")),
        max_pools=args.max_pools, max_queue=args.max_queue,
        eos_token_id=eos, pad_token_id=pad,
        temperature=args.temperature,
        top_k=args.top_k, top_p=args.top_p,
        kv_bits=8 if args.int8_kv else 16)


def serve(service, host: str, port: int, timeout: float = 600.0):
    """Build the HTTP server (returns it; call serve_forever())."""
    from wedetect_tpu_torch.data.vision_process import fetch_image

    return ThreadingHTTPServer(
        (host, port), make_handler(service, fetch_image, timeout))


def main(argv=None):
    args = parse_args(argv)
    service = build_service(args)
    httpd = serve(service, args.host, args.port, args.timeout)
    print(f"# serving on http://{args.host}:{httpd.server_port}",
          file=sys.stderr)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        threading.Thread(target=httpd.shutdown).start()
        service.shutdown()


if __name__ == "__main__":
    main()
