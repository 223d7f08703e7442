"""The kernel build cache (`wedetect_tpu_torch/ops/_build.py`) on the
CPU, with a stand-in `nvcc` on PATH that writes its `-o` file: a
library's name follows its source and the headers the source includes,
so an edited header rebuilds and an unchanged tree reuses."""

import os
import stat

import pytest

from wedetect_tpu_torch.ops import _build

FAKE_NVCC = """#!/bin/sh
out=""
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; shift; fi
  shift
done
echo "$out" >> "$NVCC_CALLS"
echo "ptxas info: fake" > "$out"
"""


@pytest.fixture
def tree(tmp_path, monkeypatch):
    csrc, bindir = tmp_path / "csrc", tmp_path / "bin"
    csrc.mkdir()
    bindir.mkdir()
    nvcc = bindir / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    calls = tmp_path / "calls"
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setenv("NVCC_CALLS", str(calls))
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    (csrc / "common.cuh").write_text("constexpr int kA = 1;\n")
    (csrc / "inner.cuh").write_text("constexpr int kB = 2;\n")
    (csrc / "outer.cuh").write_text('#include "inner.cuh"\n')
    (csrc / "kern.cu").write_text(
        '#include <stdint.h>\n#include "common.cuh"\n'
        '  #  include "outer.cuh"\nint f() { return kA + kB; }\n')
    return csrc, calls


def _ncalls(calls):
    return len(calls.read_text().splitlines()) if calls.exists() else 0


def test_unchanged_tree_reuses_the_library(tree):
    csrc, calls = tree
    first = _build.build("kern")
    assert first.exists() and _ncalls(calls) == 1
    assert first.with_suffix(".log").read_text() == ""
    assert _build.build("kern") == first
    assert _ncalls(calls) == 1


@pytest.mark.parametrize("edit", ["kern.cu", "common.cuh", "inner.cuh"])
def test_edited_source_or_header_rebuilds(tree, edit):
    """A header included directly or through another header is part of
    the library's name."""
    csrc, calls = tree
    first = _build.build("kern")
    path = csrc / edit
    path.write_text(path.read_text() + "// edited\n")
    second = _build.build("kern")
    assert second != first and second.exists()
    assert _ncalls(calls) == 2


@pytest.mark.parametrize("name", ["flash_gqa_sm90", "flash_gqa_bwd_sm90",
                                  "flash_attn_bwd_sm90", "flash_attn_sm90"])
def test_sm90_libraries_hash_the_shared_header(name):
    """Every wgmma + TMA source of the repository includes
    csrc/sm90_common.cuh, so an edit of its helpers rebuilds each."""
    names = [p.name for p in _build._sources(_build.CSRC / f"{name}.cu")]
    assert names[0] == f"{name}.cu"
    assert "sm90_common.cuh" in names and "flash_common.cuh" in names


def test_sources_follow_quoted_includes_once(tree):
    csrc, _ = tree
    (csrc / "inner.cuh").write_text('#include "outer.cuh"\n')   # a cycle
    names = [p.name for p in _build._sources(csrc / "kern.cu")]
    assert names == ["kern.cu", "common.cuh", "outer.cuh", "inner.cuh"]
