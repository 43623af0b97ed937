"""Port parity: the native text-IO library (neuralmelting_tpu_torch.io.native).

The port's native writers give the port's Python writers' bytes and the
JAX package's bytes (its native writer where built, its Python writer with
NM_NATIVE_IO=0); the port's native reader gives the JAX native reader's
arrays (the f32 values printed, as float64). Processes that build the
library at once into an empty build directory each load it. Records and
frames come from numpy seeds.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from neuralmelting_tpu.io import native as jnative
from neuralmelting_tpu.io import thermo as JT
from neuralmelting_tpu.io import traj as JJ
from neuralmelting_tpu_torch.io import native, thermo, traj

ROOT = Path(__file__).resolve().parents[1]
PARAMS = {"element": "LJ", "natoms": 32, "config": '{"seed": 3}'}


def _records(seed, nrec):
    g = np.random.default_rng(seed)
    rec = {c: (g.standard_normal(nrec) * 10.0 ** g.integers(-3, 4))
           .astype(np.float32) for c in thermo.COLUMNS}
    rec["sweep"] = np.arange(1, nrec + 1, dtype=np.int32) * 8
    return rec


def _frames(seed, nframes, natoms):
    g = np.random.default_rng(seed)
    pos = g.uniform(-1.0, 7.0, (nframes, natoms, 3)).astype(np.float32)
    box = g.uniform(5.0, 7.0, (nframes, 3)).astype(np.float32)
    return pos, box, np.arange(1, nframes + 1, dtype=np.int64) * 8


def _python(monkeypatch, fn, *a, **k):
    with monkeypatch.context() as m:
        m.setenv("NM_NATIVE_IO", "0")
        return fn(*a, **k)


def test_library_builds_and_is_used():
    assert native.get_lib() is not None, "g++ did not build nm_textio"
    assert native.writer() == "native"
    assert native.lib_path().is_relative_to(ROOT / "build")


@pytest.mark.parametrize("append", [False, True])
def test_traj_native_bytes(tmp_path, monkeypatch, append):
    pos, box, sw = _frames(1, 3, 32)
    paths = {k: str(tmp_path / f"{k}.traj") for k in ("nat", "py", "jax")}
    for k, path in paths.items():
        for part in ((0, 2), (2, 3)) if append else ((0, 3),):
            sl = slice(*part)
            args = (path, pos[sl], box[sl])
            kw = dict(sweeps=sw[sl], append=part[0] > 0)
            if k == "nat":
                assert native.write_traj(path, pos[sl], box[sl], sw[sl],
                                         part[0] > 0)
            elif k == "py":
                _python(monkeypatch, traj.write, *args, **kw)
            else:
                _python(monkeypatch, JJ.write, *args, **kw)
    got = {k: Path(p).read_bytes() for k, p in paths.items()}
    assert got["nat"] == got["py"] == got["jax"]


@pytest.mark.parametrize("as_tensor", [False, True])
def test_traj_write_takes_native_path(tmp_path, monkeypatch, as_tensor):
    pos, box, sw = _frames(2, 2, 7)
    conv = torch.as_tensor if as_tensor else (lambda a: a)
    traj.write(str(tmp_path / "t.traj"), conv(pos), conv(box),
               sweeps=conv(sw))
    JJ.write(str(tmp_path / "j.traj"), pos, box, sweeps=sw)
    _python(monkeypatch, traj.write, str(tmp_path / "p.traj"), pos, box,
            sweeps=sw)
    t = (tmp_path / "t.traj").read_bytes()
    assert t == (tmp_path / "j.traj").read_bytes()
    assert t == (tmp_path / "p.traj").read_bytes()


@pytest.mark.parametrize("params", [None, PARAMS])
@pytest.mark.parametrize("append", [False, True])
def test_thermo_native_bytes(tmp_path, monkeypatch, params, append):
    files = {}
    for tag, write, python in (("nat", thermo.write, False),
                               ("py", thermo.write, True),
                               ("jax", JT.write, True),
                               ("jaxnat", JT.write, False)):
        path = str(tmp_path / f"{tag}.thrm")
        for k, rec in enumerate((_records(3, 4), _records(4, 2))
                                if append else (_records(3, 4),)):
            kw = dict(params=params, append=k > 0)
            if python:
                _python(monkeypatch, write, path, rec, **kw)
            else:
                write(path, rec, **kw)
        files[tag] = Path(path).read_bytes()
    assert files["nat"] == files["py"] == files["jax"] == files["jaxnat"]


def test_traj_native_read_matches_jax(tmp_path, monkeypatch):
    pos, box, sw = _frames(5, 4, 20)
    path = str(tmp_path / "x.traj")
    traj.write(path, pos, box, sweeps=sw)
    got, want = traj.read(path), JJ.read(path)
    py = _python(monkeypatch, traj.read, path)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    # the native reader returns the printed f32 values; the Python one the
    # printed decimals, within an f32 rounding of them
    np.testing.assert_array_equal(got[0], pos.astype(np.float64))
    np.testing.assert_allclose(py[0], got[0], rtol=2 ** -23, atol=0)
    np.testing.assert_array_equal(py[2], got[2])


def test_native_reader_rejects_other_files(tmp_path):
    path = tmp_path / "x.txt"
    path.write_text("# something else\n1 2 3\n")
    with pytest.raises(ValueError, match="nm-traj-1"):
        native.read_traj(str(path))


def test_native_io_off_switch(monkeypatch):
    monkeypatch.setenv("NM_NATIVE_IO", "0")
    assert native.get_lib() is None and native.writer() == "python"
    assert native.read_traj("missing.traj") is None
    assert jnative.get_lib() is None


_BUILD = r"""
import sys
from pathlib import Path
from neuralmelting_tpu_torch.io import native
native.BUILD_ROOT = Path(sys.argv[1])
lib = native.get_lib()
assert lib is not None
print("LOADED", native.lib_path())
"""


def test_concurrent_builds_all_load(tmp_path):
    """Four processes build into one empty directory at once; each loads
    a whole library and no temporary file is left behind."""
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(tmp_path)],
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
        assert "LOADED" in out
    files = sorted(f.name for f in tmp_path.rglob("*") if f.is_file())
    assert files == [native.LIBNAME]
