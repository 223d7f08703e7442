"""Build and load the port's CUDA kernels.

Each `csrc/*.cu` file exposes a plain C interface. On first use it is
compiled with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v
         -o build/kernels/<name>-<hash>.so csrc/<name>.cu

into `build/kernels/` at the root of the checkout (ptxas's report beside
it as `<name>-<hash>.log`) and loaded with ctypes. The file name
carries a hash of the flags, the source and every `csrc/*.cuh` header it
includes (`#include "x.cuh"`, followed into headers), so an edited
source or header is rebuilt and a built one is reused. Nothing here
runs at import time: the CPU tests import every module, and a CPU-only
machine has no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def cuda_tool(name: str = "nvcc") -> str:
    """A CUDA toolkit binary (nvcc, cuobjdump): on PATH, else under
    CUDA_HOME or /usr/local/cuda."""
    found = shutil.which(name)
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", name)
    if not os.path.exists(path):
        raise RuntimeError(f"{name} not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return path


def _sources(src: Path) -> List[Path]:
    """src and the csrc headers it includes, each once, in include
    order."""
    seen: List[Path] = []
    todo = [src]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            dep = path.parent / inc.decode()
            if dep.exists():
                todo.append(dep)
    return seen


def build(name: str) -> Path:
    """Compile csrc/<name>.cu (if not built yet) and return the .so."""
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources(src):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    out = BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build to a private name, then rename: a concurrent build never
    # loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [cuda_tool(), *NVCC_FLAGS, "-o", tmp, str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) for {src}:\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    # ptxas -v: registers, shared memory and spills of every kernel
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(build(name)))
        return lib
