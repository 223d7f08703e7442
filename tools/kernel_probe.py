"""What the kernel timing tools (tools/time_k2_bwd.py,
tools/time_k3_bwd.py) share: a variant build of one kernel source, and
its ptxas report and SASS mix.
"""

from __future__ import annotations

import ctypes
import subprocess


def build_variant(spec, name):
    """The variant `spec` (nvcc flags, and optionally a .cu source in
    place of csrc/<name>.cu; headers are read from csrc/) built into
    build/kernels/<name>-variant.so with ptxas's report beside it, and
    loaded with ctypes: (library, path). The caller sets the argtypes."""
    from wedetect_tpu_torch.ops import _build

    srcs = [a for a in spec if a.endswith(".cu")]
    flags = [a for a in spec if not a.endswith(".cu")]
    src = srcs[0] if srcs else str(_build.CSRC / f"{name}.cu")
    out = _build.BUILD_DIR / f"{name}-variant.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(
        [_build.cuda_tool(), *_build.NVCC_FLAGS, *flags, "-I",
         str(_build.CSRC), "-o", str(out), src],
        capture_output=True, text=True, check=True)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    return ctypes.CDLL(str(out)), out


def sass_report(C, lib_path):
    """Print a library's ptxas report; its SASS mix (chip_smoke.sass_mix:
    FFMA and shared-memory loads, whole and by innermost loop), registers
    and spill lines. C is the chip_smoke module."""
    from wedetect_tpu_torch.ops import _build

    log = lib_path.with_suffix(".log").read_text()
    print(log.strip(), flush=True)
    sass = subprocess.run([_build.cuda_tool("cuobjdump"), "-sass",
                           str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    return {"sass": C.sass_mix(sass), "registers": C.ptxas_registers(lib_path),
            "spills": [ln for ln in log.splitlines() if "spill" in ln]}
