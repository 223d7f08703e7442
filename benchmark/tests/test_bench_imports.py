"""What the benchmark may import: the top-level module names compared
whole (the port's name begins with the JAX package's), the reference
nothing of the program, and no file of the benchmark JAX."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.harness import forbidden_modules

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_names_compared_whole():
    names = ["jax", "jax.numpy", "jaxlib.xla", "flax.linen", "wedetect_tpu",
             "wedetect_tpu.ops", "wedetect_tpu_torch", "wedetect_tpu_torch.ops",
             "jaxtyping", "flaxx", "numpy"]
    assert forbidden_modules(names) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla", "flax.linen", "wedetect_tpu",
         "wedetect_tpu.ops"])


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_in_the_benchmark(path):
    tops = {m.split(".")[0] for m in imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "wedetect_tpu"}
    if "reference" in path.parts:
        assert "wedetect_tpu_torch" not in tops
        assert not any(m.startswith("benchmark.entries")
                       for m in imports(path))


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.detector, "
            "benchmark.reference.qwen3vl, benchmark.reference.compare_det, "
            "benchmark.reference.flops, benchmark.reference.letterbox\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('wedetect_tpu_torch', 'wedetect_tpu', 'jax', 'flax')]\n"
            "print(bad); sys.exit(1 if bad else 0)" % str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_no_result_without_a_card(tmp_path):
    """Where torch finds no CUDA device the run exits non-zero before a
    result line."""
    r = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "det_base_lvis_b16", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
             "HOME": str(tmp_path)})
    assert r.returncode != 0
    assert r.stdout.strip() == ""
