"""Run a Python snippet as the ranks of a torch.distributed gloo world
on the CPU, for the port's multi-process tests: each rank is a
subprocess joined through `eval/dist.maybe_initialize` (WEDETECT_DIST=1,
a file:// rendezvous, no port), with one intra-op thread. The snippet
reads `OUT` (a directory), `ARGS` (the extra arguments), `RANK` and
`WORLD`, and writes its results there; it must not import JAX."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PRELUDE = """
import sys
import torch
torch.set_num_threads(1)
from wedetect_tpu_torch.eval import dist as _dist
_dist.maybe_initialize("cpu")
RANK = _dist.process_index()
WORLD = _dist.process_count()
OUT = sys.argv[1]
ARGS = sys.argv[2:]
"""


def run_ranks(script: str, out, *args, world: int = 2,
              timeout: float = 120, env=None) -> None:
    """Run `script` (after PRELUDE) in `world` processes; raise with a
    rank's stderr if any fails."""
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    rendezvous = out / "rendezvous"
    if rendezvous.exists():
        rendezvous.unlink()
    path = os.pathsep.join([str(ROOT), str(ROOT / "tests")])
    procs = []
    for rank in range(world):
        e = dict(os.environ, PYTHONPATH=path, WEDETECT_DIST="1",
                 RANK=str(rank), WORLD_SIZE=str(world), OMP_NUM_THREADS="1",
                 WEDETECT_DIST_INIT=f"file://{rendezvous}", **(env or {}))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", PRELUDE + script, str(out),
             *map(str, args)], env=e, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=timeout)
            errs.append(err)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, err) in enumerate(zip(procs, errs)):
        assert p.returncode == 0, f"rank {rank}:\n{err[-4000:]}"
