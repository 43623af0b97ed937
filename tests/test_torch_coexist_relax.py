"""The port's coexistence preparation and relaxation against the JAX
package's chains of the same schedule (tests/golden/coexist_relax_jax.json,
made by tests/make_coexist_reference.py on the CPU).

At ``coexist_run --fast`` size: prep_liquid at 4x4x4 LJ cells (melt at
T* 2.2, hold at 0.80), build_coexist_setup at 8x4x4 cells over T* (0.70,
0.76, 0.82) and three relaxation chunks of 2 records x 20 sweeps with
exchange off, as the port's chains of prep seeds 31-34 against the JAX
chains of the same seeds, mean against mean. Limits, set from the
phases' separations: the solid's PE/atom lies about 0.8-1.0 below the
liquid's at these T, and its density about 12% above. So a liquid that
froze in one package and not in the other fails, and the chains'
fluctuation passes:

- the prepared liquid's number density within 5% of the JAX chains'
  mean, and its PE/atom within 0.15;
- in each chunk and at each T, the liquid row's PE/atom less the solid
  row's within 0.25 of the JAX chains' mean.

In both packages the prepared liquid keeps nearly the lattice's density
(0.976-0.999) and the liquid row's gap over the solid row falls from
0.13-0.22 in the first chunk to -0.02..+0.05 in the second, the first
measured chunk of ``coexist_run --fast``: the reference protocol's
liquid row freezes (ROADMAP C9). The cellmc engine draws the JAX key
chain, so the port's chains track the JAX chains of the same seeds to
~1e-5 PE/atom through the second chunk; a decision at an f32 margin can
part them in the third.

Sampling runs on one torch thread (the tests share the machine).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from neuralmelting_tpu_torch import coexist as TC
from neuralmelting_tpu_torch import runner
from neuralmelting_tpu_torch.models.lj import LJCut
from neuralmelting_tpu_torch.ops.energy import pair_energy_virial

REF = Path(__file__).resolve().parent / "golden" / "coexist_relax_jax.json"
DENSITY_RTOL, PE_ATOL, GAP_ATOL = 0.05, 0.15, 0.25


@pytest.fixture(scope="module")
def ref():
    with open(REF) as f:
        return json.load(f)


def port_chain(ref, seed):
    """One chain of the reference's schedule through the port on the
    CPU: the prepared liquid's density and PE/atom, and each chunk's
    (solid, liquid, two-phase) rows of PE/atom."""
    p = ref["prep"]
    liq_pos, liq_box = TC.prep_liquid(
        "LJ", p["ncells"], temp_melt=p["temp_melt"],
        temp_hold=p["temp_hold"], press=p["press"], seed=seed, mod=p["mod"],
        melt_records=p["melt_records"], hold_records=p["hold_records"],
        device="cpu")
    n = len(liq_pos)
    pe, _w = pair_energy_virial(LJCut.create(), torch.as_tensor(liq_pos),
                                torch.as_tensor(liq_box))
    setup = TC.build_coexist_setup(
        "LJ", ref["cells"], ref["temps"], press=p["press"],
        liquid_pos=liq_pos, liquid_box=liq_box, mod=ref["mod"],
        gap=ref["gap"], device="cpu")
    rows = []
    for _ in range(ref["chunks"]):
        setup, recs, _fr, hist, xacc, diag = runner.run_sampling(
            setup, write_files=False, write_traj=False,
            nrecords=ref["records"], exchange=False)
        assert int(diag) == 0 and int(xacc.sum()) == 0
        rows.append(TC.row_pe_per_atom(recs.pe.numpy(), hist.numpy(),
                                       setup.natoms, len(ref["temps"])))
    return {"liquid_density": n / float(np.prod(np.asarray(liq_box,
                                                           np.float64))),
            "liquid_pe_per_atom": float(pe) / n, "rows": rows}


@pytest.fixture(scope="module")
def port(ref):
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return [port_chain(ref, seed) for seed in ref["chain_seeds"]]
    finally:
        torch.set_num_threads(n_threads)


@pytest.mark.parametrize("key,rtol,atol", [
    ("liquid_density", DENSITY_RTOL, 0.0),
    ("liquid_pe_per_atom", 0.0, PE_ATOL)])
def test_prepared_liquid_matches_jax_chains(ref, port, key, rtol, atol):
    got = np.mean([c[key] for c in port])
    want = np.mean([c[key] for c in ref["chains"]])
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def gaps(chains):
    rows = np.asarray([c["rows"] for c in chains])   # (chain, chunk, 3, T)
    return rows[:, :, TC.ROW_LIQUID] - rows[:, :, TC.ROW_SOLID]


def test_relaxation_gap_matches_jax_chains(ref, port):
    got = gaps(port)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got.mean(0), gaps(ref["chains"]).mean(0),
                               rtol=0, atol=GAP_ATOL)
