"""Build and load the CUDA kernels of ``csrc/`` at first use.

``nvcc`` compiles every ``csrc/*.cu`` to an object, one process per
source, all started together, and links the objects into one shared
library with a plain C interface, loaded with ``ctypes``. The library
lands in ``build/neuralmelting_tpu_torch/<hash>/`` under the repository
root, keyed on a hash of the sources and the flags, so an edit rebuilds
and an unchanged tree reuses the last build. Nothing runs at import time:
the first CUDA tensor that reaches a kernel wrapper triggers ``load()``.

Flags: ``sm_90a`` (Hopper), ``-fmad=false`` and nvcc's default IEEE
division, square root and denormals, so each kernel's per-pair f32
arithmetic is the plain PyTorch version's. No library of ready-made
kernels is linked.
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
         "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas=-v"]
LIBNAME = "libnm_cellmc.so"

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # x, y, z, params, pot3, scale, out, R, nx, ny, nz, K, stream
    "nm_cellmc_total": [_P] * 7 + [_I] * 5 + [_P],
    # x, y, z, count, params, pot3, seeds, stats, R, nx, ny, nz, K, J,
    # ncyc, rt, stream
    "nm_cellmc_sweep": [_P] * 8 + [_I] * 8 + [_P],
    # nx, ny, nz, K -> dynamic shared memory bytes of the sweep kernel
    "nm_cellmc_sweep_smem": [_I] * 4,
    # x, y, z, params, scal, c_phi, c_phid, c_rho, c_rhod, c_f, c_fd,
    # scale, stats, rho, fp, R, nx, ny, nz, K, n_phi, n_rho, n_f,
    # with_virial, stream
    "nm_eam_total": [_P] * 15 + [_I] * 9 + [_P],
    # x, y, z, rho, count, params, scal, c_phi, c_rho, c_f, seeds, stats,
    # R, nx, ny, nz, K, n_phi, n_rho, n_f, ncyc, rt, stream
    "nm_eam_sweep": [_P] * 12 + [_I] * 10 + [_P],
    # nx, ny, nz, K -> dynamic shared memory bytes of the EAM sweep
    "nm_eam_sweep_smem": [_I] * 4,
    # pos, box, ids, old_r, new_r, out, R, N, M, sig2, rc2, 4 eps,
    # 24 eps, stream
    "nm_lj_delta": [_P] * 6 + [_I] * 3 + [_F] * 4 + [_P],
    # variant, a, b, out, n, sig2, rc2, stream
    "nm_vpu_probe": [_I] + [_P] * 3 + [_I] + [_F] * 2 + [_P],
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


def _run(cmds):
    """Run the commands at once; return their joined output, or raise
    with it if any failed."""
    procs = [(c, subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True))
             for c in cmds]
    logs, failed = [], False
    for cmd, proc in procs:
        out, _ = proc.communicate()
        logs.append(" ".join(cmd) + "\n" + out)
        failed |= proc.returncode != 0
    if failed:
        raise RuntimeError("nvcc failed:\n" + "".join(logs))
    return "".join(logs)


def build() -> Path:
    """Compile the library if this source hash has none yet; return it."""
    out = build_dir() / LIBNAME
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    srcs = sorted(CSRC.glob("*.cu"))
    objs = [out.with_name(f"{p.stem}.{os.getpid()}.o") for p in srcs]
    log = _run([[nvcc(), *FLAGS, "-c", "-o", str(o), str(p)]
                for p, o in zip(srcs, objs)])
    tmp = out.with_name(f"{LIBNAME}.{os.getpid()}.tmp")
    log += _run([[nvcc(), "-shared", "-o", str(tmp), *map(str, objs)]])
    (out.parent / "build.log").write_text(log)
    for o in objs:
        o.unlink()
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
