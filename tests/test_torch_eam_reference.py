"""chip_smoke.py's EAM physics check against its JAX reference.

eam-physics holds the port's config-3 chains to eam_config3_gather.json,
written by scripts/eam_config3_reference.py from the JAX gather engine.
These CPU tests pin that the two sides describe the same run and reduce
records the same way:

* chip_smoke.config3 is the reference's configuration (the JAX
  RunConfig's to_json), for every chain seed;
* chip_smoke.slot_batches (slots by sorting each record's temperatures)
  gives the reference's batch means (slots by the JAX package's
  slot_order_features over the replica -> slot history), on records
  whose replicas swap slots every record;
* the reference file holds pooled means with the standard errors of its
  batch means, and one entry per chain with 10 x 48 features.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from neuralmelting_tpu import pipeline as JP

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _script():
    path = os.path.join(REPO, "scripts", "eam_config3_reference.py")
    spec = importlib.util.spec_from_file_location("eam_config3_ref", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref():
    with open(chip_smoke.REFERENCE) as f:
        return json.load(f)


@pytest.mark.parametrize("seed", [5, 12])
def test_config3_is_the_reference_configuration(ref, seed):
    script = _script()
    assert chip_smoke.config3(seed).to_json() == \
        script.config3(seed).to_json()
    assert json.loads(script.config3(seed).to_json())["seed"] == seed
    assert ref["config"] == json.loads(script.config3(
        ref["chain_seeds"][0]).to_json())
    assert ref["chain_seeds"] == list(script.CHAIN_SEEDS)


def test_slot_batches_match_the_reference_reduction():
    script = _script()
    g = np.random.default_rng(3)
    nrec, ntemp, natoms, ncut = 40, 10, 256, 15
    temps = np.linspace(400.0, 2200.0, ntemp).astype(np.float32)
    hist = np.stack([g.permutation(ntemp) for _ in range(nrec)])
    pe = g.normal(-800.0, 5.0, (nrec, ntemp)).astype(np.float32)
    vol = g.normal(4300.0, 20.0, (nrec, ntemp)).astype(np.float32)
    vir = g.normal(-60.0, 30.0, (nrec, ntemp)).astype(np.float32)
    rec_temp = temps[hist]                   # replica r sits in slot hist

    class Res:
        records = type("R", (), dict(
            temp=torch.as_tensor(rec_temp), pe=torch.as_tensor(pe),
            vol=torch.as_tensor(vol), virial=torch.as_tensor(vir)))

    got = chip_smoke.slot_batches(Res, ncut, script.NBATCH, natoms)

    def slot(v):
        return JP.slot_order_features(np.asarray(v, np.float64),
                                      hist)[ncut:]

    t, v = slot(rec_temp), slot(vol)
    want = {"pe_per_atom_eV": script.batches(slot(pe) / natoms),
            "vol_A3": script.batches(v),
            "pvir_eV_per_A3": script.batches(
                (natoms * script.KB * t + slot(vir) / 3.0) / v)}
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-12,
                                   err_msg=key)


def test_reference_file_is_complete(ref):
    nt, nchain = len(ref["temp_K"]), len(ref["chain_seeds"])
    assert nt == 10 and nchain >= 4
    for key in ("pe_per_atom_eV", "vol_A3", "pvir_eV_per_A3"):
        m, se = np.asarray(ref[key]), np.asarray(ref[key + "_se"])
        assert m.shape == se.shape == (nt,) and (se > 0).all()
        b = np.concatenate([c["batch_" + {"pe_per_atom_eV": "pe_per_atom",
                                          "vol_A3": "vol",
                                          "pvir_eV_per_A3": "pvir"}[key]]
                            for c in ref["chains"]])
        assert b.shape == (nchain * ref["batches_per_chain"], nt)
        np.testing.assert_allclose(b.mean(0), m, rtol=1e-12)
    pe = np.asarray(ref["pe_per_atom_eV"])
    assert (np.diff(pe) > 0).all() and (np.diff(ref["vol_A3"]) > 0).all()
    for c in ref["chains"]:
        assert c["diag"] == 0
        assert np.asarray(c["g_slot"]).shape == (nt, ref["nbins"])
