"""Port parity: the .thrm and .traj text formats, byte for byte.

The port's io/thermo.py and io/traj.py against the JAX package's Python
writers and readers on the same records (numpy, from a seed). The JAX
writers are held to their Python path with NM_NATIVE_IO=0, so no test here
builds the native text-IO library.
"""

import numpy as np
import pytest
import torch

from neuralmelting_tpu.io import thermo as JT
from neuralmelting_tpu.io import traj as JJ
from neuralmelting_tpu_torch.io import thermo, traj

PARAMS = {"element": "LJ", "natoms": 256, "config": "baseline-config1 seed=256"}


@pytest.fixture(autouse=True)
def python_writers(monkeypatch):
    monkeypatch.setenv("NM_NATIVE_IO", "0")


def _records(seed, nrec):
    g = np.random.default_rng(seed)
    rec = {c: g.standard_normal(nrec).astype(np.float32) * 10.0 ** g
           .integers(-3, 4) for c in thermo.COLUMNS}
    rec["sweep"] = np.arange(1, nrec + 1, dtype=np.int32) * 4
    rec["acc_hmc"][0] = 0.0
    return rec


def _frames(seed, nframes, natoms):
    g = np.random.default_rng(seed)
    pos = g.uniform(-1.0, 7.0, (nframes, natoms, 3)).astype(np.float32)
    box = g.uniform(5.0, 7.0, (nframes, 3)).astype(np.float32)
    return pos, box, np.arange(nframes, dtype=np.int64) * 8


def test_formats_are_the_jax_package_formats():
    assert thermo.COLUMNS == JT.COLUMNS
    assert thermo.MAGIC == JT.MAGIC and traj.MAGIC == JJ.MAGIC


@pytest.mark.parametrize("params", [None, PARAMS])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_thermo_bytes(tmp_path, params, as_tensor):
    rec = _records(0, 5)
    port = {c: torch.as_tensor(v) for c, v in rec.items()} if as_tensor \
        else rec
    thermo.write(str(tmp_path / "t.thrm"), port, params=params)
    JT.write(str(tmp_path / "j.thrm"), rec, params=params)
    assert (tmp_path / "t.thrm").read_bytes() == \
        (tmp_path / "j.thrm").read_bytes()


def test_thermo_append_bytes(tmp_path):
    for name, mod in (("t", thermo), ("j", JT)):
        path = str(tmp_path / f"{name}.thrm")
        mod.write(path, _records(1, 3), params=PARAMS)
        mod.write(path, _records(2, 2), append=True)
    assert (tmp_path / "t.thrm").read_bytes() == \
        (tmp_path / "j.thrm").read_bytes()


def test_thermo_read_matches_jax(tmp_path):
    path = str(tmp_path / "j.thrm")
    JT.write(path, _records(3, 4), params=PARAMS)
    p_t, d_t = thermo.read(path)
    p_j, d_j = JT.read(path)
    assert p_t == p_j
    for c in thermo.COLUMNS:
        assert d_t[c].dtype == d_j[c].dtype
        np.testing.assert_array_equal(d_t[c], d_j[c])


@pytest.mark.parametrize("sweeps", [False, True])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_traj_bytes(tmp_path, sweeps, as_tensor):
    pos, box, sw = _frames(4, 3, 7)
    kw = dict(sweeps=sw) if sweeps else {}
    if as_tensor:
        traj.write(str(tmp_path / "t.traj"), torch.as_tensor(pos),
                   torch.as_tensor(box),
                   **({"sweeps": torch.as_tensor(sw)} if sweeps else {}))
    else:
        traj.write(str(tmp_path / "t.traj"), pos, box, **kw)
    JJ.write(str(tmp_path / "j.traj"), pos, box, **kw)
    assert (tmp_path / "t.traj").read_bytes() == \
        (tmp_path / "j.traj").read_bytes()


def test_traj_append_and_read(tmp_path):
    for name, mod in (("t", traj), ("j", JJ)):
        path = str(tmp_path / f"{name}.traj")
        for k in range(2):
            pos, box, sw = _frames(5 + k, 2, 4)
            mod.write(path, pos, box, sweeps=sw + 16 * k, append=k > 0)
    assert (tmp_path / "t.traj").read_bytes() == \
        (tmp_path / "j.traj").read_bytes()
    got, want = traj.read(str(tmp_path / "t.traj")), \
        JJ.read(str(tmp_path / "j.traj"))
    assert got[0].shape == (4, 4, 3)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_readers_reject_other_files(tmp_path):
    path = tmp_path / "x.txt"
    path.write_text("# something else\n1 2 3\n")
    with pytest.raises(ValueError, match="nm-thrm-1"):
        thermo.read(str(path))
    with pytest.raises(ValueError, match="nm-traj-1"):
        traj.read(str(path))
