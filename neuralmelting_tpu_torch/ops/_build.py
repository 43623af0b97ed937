"""Build and load the CUDA kernels of ``csrc/`` at first use.

``nvcc`` compiles every ``csrc/*.cu`` into one shared library with a plain
C interface, loaded with ``ctypes``. The library lands in
``build/neuralmelting_tpu_torch/<hash>/`` under the repository root, keyed
on a hash of the sources and the flags, so an edit rebuilds and an
unchanged tree reuses the last build. Nothing runs at import time: the
first CUDA tensor that reaches a kernel wrapper triggers ``load()``.

Flags: ``sm_90a`` (Hopper), ``-fmad=false`` and nvcc's default IEEE
division and denormals, so each kernel's per-pair f32 arithmetic is the
plain PyTorch version's. No library of ready-made kernels is linked.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = (Path(__file__).resolve().parents[2] / "build"
              / "neuralmelting_tpu_torch")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]
LIBNAME = "libnm_cellmc.so"

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # x, y, z, params, pot3, scale, out, R, nx, ny, nz, K, stream
    "nm_cellmc_total": [_P] * 7 + [_I] * 5 + [_P],
    # x, y, z, count, params, pot3, seeds, stats, R, nx, ny, nz, K, J,
    # ncyc, rt, stream
    "nm_cellmc_sweep": [_P] * 8 + [_I] * 8 + [_P],
    # nx, ny, nz, K -> dynamic shared memory bytes of the sweep kernel
    "nm_cellmc_sweep_smem": [_I] * 4,
}

_lib = None


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, else PATH, else PyTorch's guess."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit "
                       "to build the neuralmelting_tpu_torch kernels")


def sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> Path:
    """Compile the library if this source hash has none yet; return it."""
    out = build_dir() / LIBNAME
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{LIBNAME}.{os.getpid()}.tmp")
    cmd = [nvcc(), *FLAGS, "-o", str(tmp),
           *[str(p) for p in sorted(CSRC.glob("*.cu"))]]
    res = subprocess.run(cmd, capture_output=True, text=True)
    (out.parent / "build.log").write_text(
        " ".join(cmd) + "\n" + res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out


def build_log() -> str:
    p = build_dir() / "build.log"
    return p.read_text() if p.exists() else ""


def load():
    """The kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
