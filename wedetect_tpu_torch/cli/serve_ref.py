"""Batch generation serving CLI: continuous batching over a request file.

    python -m wedetect_tpu_torch.cli.serve_ref \
        --ref_checkpoint <hf-dir> --requests reqs.jsonl \
        [--slots 8 --chunk 16 --max_new_tokens 64 --int8-decode]

Port of `wedetect_tpu/cli/serve_ref.py`: RefScorer.generate_batch ->
models/serve.GenServer (a slot pool over one KV pool on the card,
mid-run admission, pipelined chunked decode). reqs.jsonl holds one JSON
object a line, {"image": <path / URL / data URI>, "prompt": "..."}
(image sources as data/vision_process.fetch_image reads them). Output:
one JSON line a request, {"id", "image", "text"}, in input order, and a
throughput line on stderr. --random-init serves a miniature random Ref
with a stub tokenizer (a smoke run); --device cpu runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="WeDetect-Ref continuous-batching generation (PyTorch)")
    p.add_argument("--ref_checkpoint", default="")
    p.add_argument("--random-init", action="store_true",
                   help="a miniature random Ref (smoke run)")
    p.add_argument("--requests", required=True,
                   help="JSONL: {'image': path/URL, 'prompt': str}")
    p.add_argument("--out", default="", help="write JSONL here "
                   "instead of stdout")
    p.add_argument("--max_new_tokens", type=int, default=64)
    p.add_argument("--slots", type=int, default=8)
    p.add_argument("--chunk", type=int, default=16)
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--f32", dest="bf16", action="store_false")
    p.add_argument("--int8-decode", action="store_true",
                   help="weight-only int8 decode (models/quant)")
    p.add_argument("--int4-decode", action="store_true",
                   help="weight-only packed-int4 decode (models/quant; "
                        "lossier, validate per checkpoint)")
    p.add_argument("--int8-kv", action="store_true",
                   help="int8 KV cache pool (models/serve kv_bits=8): "
                        "~0.52x the KV pool; lossy like weight-only int8")
    p.add_argument("--piggyback", action="store_true",
                   help="ride admission prefills on the decode chunks")
    p.add_argument("--temperature", type=float, default=0.0,
                   help="sampling temperature (0 = greedy); streams are "
                        "per request (--seed + request index)")
    p.add_argument("--top_k", type=int, default=0,
                   help="keep only the k highest logits (0 = off)")
    p.add_argument("--top_p", type=float, default=1.0,
                   help="nucleus sampling mass (1.0 = off)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def load_scorer(args):
    """(RefScorer, tokenizer) of the serving CLIs' arguments."""
    from wedetect_tpu_torch.cli._ref_load import load_ref, tiny_random_ref
    from wedetect_tpu_torch.models.ref_api import RefScorer

    if args.random_init:
        cfg, model, tok = tiny_random_ref(args.device)
    else:
        cfg, model, tok = load_ref(args.ref_checkpoint, args.device)
    scorer = RefScorer(cfg=cfg, model=model, tokenizer=tok,
                       dtype="bfloat16" if args.bf16 else "float32",
                       device=args.device,
                       quantize_decode="int4" if args.int4_decode
                       else args.int8_decode)
    return scorer, tok


def special_ids(tok):
    """(eos, pad) ids of a tokenizer: <|im_end|> and its pad token
    (Qwen's defaults without one)."""
    eos = (tok.convert_tokens_to_ids("<|im_end|>")
           if hasattr(tok, "convert_tokens_to_ids") else 151645)
    pad = getattr(tok, "pad_token_id", None)
    return eos, 151643 if pad is None else pad


def main(argv=None):
    args = parse_args(argv)
    from wedetect_tpu_torch.data.vision_process import fetch_image

    scorer, tok = load_scorer(args)
    reqs = []
    with open(args.requests) as f:
        for line in f:
            line = line.strip()
            if line:
                r = json.loads(line)
                reqs.append((r["image"], r["prompt"]))
    images = [fetch_image(src) for src, _ in reqs]
    eos, pad = special_ids(tok)
    t0 = time.perf_counter()
    texts = scorer.generate_batch(
        [(img, prompt) for img, (_, prompt) in zip(images, reqs)],
        max_new_tokens=args.max_new_tokens, eos_token_id=eos,
        pad_token_id=pad, slots=args.slots, chunk=args.chunk,
        piggyback=args.piggyback, temperature=args.temperature,
        top_k=args.top_k, top_p=args.top_p, seed=args.seed,
        kv_bits=8 if args.int8_kv else 16)
    dt = time.perf_counter() - t0
    sink = open(args.out, "w") if args.out else sys.stdout
    for i, ((src, _), text) in enumerate(zip(reqs, texts)):
        sink.write(json.dumps({"id": i, "image": src, "text": text},
                              ensure_ascii=False) + "\n")
    if args.out:
        sink.close()
    print(f"{len(reqs)} requests in {dt:.2f}s "
          f"({len(reqs) / dt:.2f} req/s, slots={args.slots}, "
          f"chunk={args.chunk})", file=sys.stderr)
    return texts


if __name__ == "__main__":
    main()
