"""ctypes binding of the native text-IO library (``nm_textio.cpp``), the
port's copy of ``neuralmelting_tpu.io.native``.

g++ compiles the library at first use into
``build/neuralmelting_tpu_torch/textio/<source hash>/`` under the
repository root, beside the CUDA kernels (``ops/_build.py``). A build
writes a file whose name is unique to its process and moves it into
place with ``os.replace``, so processes that build at once (test workers)
each end up loading one whole library. Without a C++ toolchain, or with
``NM_NATIVE_IO=0`` (the JAX package's switch), every entry point returns
None or False and ``io/thermo.py`` and ``io/traj.py`` use their Python
writers and readers, the reference: the bytes written are the same either
way (tests/test_torch_native_io.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import uuid
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "nm_textio.cpp"
BUILD_ROOT = (Path(__file__).resolve().parents[3] / "build"
              / "neuralmelting_tpu_torch" / "textio")
FLAGS = ["-O3", "-shared", "-fPIC"]
LIBNAME = "libnm_textio.so"

_L, _I, _P, _S = ctypes.c_long, ctypes.c_int, ctypes.c_void_p, ctypes.c_char_p
_SIGNATURES = {
    # path, append, nframes, natoms, pos, boxes, sweeps
    "nm_write_traj": [_S, _I, _L, _L, _P, _P, _P],
    # path, &nframes, &natoms
    "nm_scan_traj": [_S, _P, _P],
    # path, nframes, natoms, pos, boxes, sweeps
    "nm_read_traj": [_S, _L, _L, _P, _P, _P],
    # path, append, nrec, ncol, data, header
    "nm_write_thermo": [_S, _I, _L, _L, _P, _S],
}

_lock = threading.Lock()
_lib = None
_tried = False


def lib_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIBNAME


def build() -> Path:
    """Compile the library if this source has none yet; return its path.
    Raises when g++ fails or is missing."""
    out = lib_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{LIBNAME}.{os.getpid()}.{uuid.uuid4().hex}.tmp")
    try:
        subprocess.run(["g++", *FLAGS, str(SRC), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


def get_lib():
    """The loaded library, or None when NM_NATIVE_IO=0 or no toolchain."""
    global _lib, _tried
    if os.environ.get("NM_NATIVE_IO", "1") == "0":
        return None
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, subprocess.SubprocessError):
            return None
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        _lib = lib
        return _lib


def writer() -> str:
    """Which text writer a write takes now: "native" or "python"."""
    return "python" if get_lib() is None else "native"


def write_traj(path, positions, boxes, sweeps, append: bool) -> bool:
    lib = get_lib()
    if lib is None:
        return False
    pos = np.ascontiguousarray(positions, np.float32)
    box = np.ascontiguousarray(boxes, np.float32)
    sw = np.ascontiguousarray(sweeps, np.int64)
    nframes, natoms, _ = pos.shape
    if box.shape != (nframes, 3) or sw.shape != (nframes,):
        raise ValueError(f"traj shapes: positions {pos.shape}, boxes "
                         f"{box.shape}, sweeps {sw.shape}")
    rc = lib.nm_write_traj(str(path).encode(), int(append), nframes, natoms,
                           pos.ctypes.data, box.ctypes.data, sw.ctypes.data)
    return rc == 0


def read_traj(path):
    """(positions, boxes, sweeps), or None when the library is off."""
    lib = get_lib()
    if lib is None:
        return None
    nframes, natoms = ctypes.c_long(), ctypes.c_long()
    rc = lib.nm_scan_traj(str(path).encode(), ctypes.addressof(nframes),
                          ctypes.addressof(natoms))
    if rc == -3:
        raise ValueError(f"{path}: not a # nm-traj-1 file")
    if rc != 0:
        return None
    f, n = nframes.value, natoms.value
    pos = np.empty((f, n, 3), np.float32)
    box = np.empty((f, 3), np.float32)
    sw = np.empty((f,), np.int64)
    rc = lib.nm_read_traj(str(path).encode(), f, n, pos.ctypes.data,
                          box.ctypes.data, sw.ctypes.data)
    if rc != 0:
        return None
    return pos.astype(np.float64), box.astype(np.float64), sw


def write_thermo_rows(path, data_2d, header: str, append: bool) -> bool:
    lib = get_lib()
    if lib is None:
        return False
    data = np.ascontiguousarray(data_2d, np.float64)
    nrec, ncol = data.shape
    rc = lib.nm_write_thermo(str(path).encode(), int(append), nrec, ncol,
                             data.ctypes.data, header.encode())
    return rc == 0
