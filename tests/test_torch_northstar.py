"""The port's north-star run (neuralmelting_tpu_torch.northstar) against
the JAX package's pieces and against itself.

- featurize_chunk on seeded frames with a permuted replica -> slot map:
  the JAX package's rdf_frames and slot_order_features composed the same
  way give the same pair counts (g within f32 rounding of the shell
  normalisation, rtol 1e-6) and the same box means.
- The nominal attempt count and the first-chunk excess equal
  scripts/northstar2.py's formulas (:358-366, :372-391), restated here
  with the JAX package's geometry, cycle count and volume trials.
- A tiny schedule (4x4x4 cells, a 2x4 grid, 1 eq + 2 samp chunks of 2
  records x 4 sweeps, a checkpoint after every chunk) stopped in its
  second samp chunk and resumed gives the uninterrupted run's
  tm_by_pressure, feature files and sq.npz bit for bit, and
  attempts_to_complete 2.
- The stale-vintage guard wipes a state written under another chunking.
- Nothing is written outside the state directory and the result path;
  the default device raises without a GPU.

Sampling runs on one torch thread (the tests share the machine).
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralmelting_tpu import runner as JRUN
from neuralmelting_tpu.features import rdf as JR
from neuralmelting_tpu.ops.pallas import cellmc as JCM
from neuralmelting_tpu.pipeline import slot_order_features as j_slot_order
from neuralmelting_tpu.sampler import cellmc as JSC
from neuralmelting_tpu_torch import northstar as NS
from neuralmelting_tpu_torch import runner as TR
from neuralmelting_tpu_torch.features import rdf as TRDF
from neuralmelting_tpu_torch.models.lattice import make_supercell

SCHED = dict(eq_chunks=1, samp_chunks=2, records=2)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_cfg():
    return dataclasses.replace(
        NS.make_cfg(fast=True), npress=2, ntemp=4, press=(1.0, 5.0),
        temp=tuple(float(t) for t in np.linspace(0.55, 1.55, 4)), mod=4)


def test_featurize_chunk_matches_jax():
    nrec, r, nbins, rmax = 2, 6, NS.NBINS, 2.3
    lat, box = make_supercell("fcc", 1.6, 3)                  # 108 atoms
    rng = np.random.default_rng(3)
    pos = (lat + 0.1 * rng.standard_normal((nrec, r) + lat.shape)).astype(
        np.float32)
    boxes = (box * rng.uniform(0.99, 1.02, (nrec, r, 1))).astype(np.float32)
    hist = np.stack([rng.permutation(r) for _ in range(nrec)])
    g, b = NS.featurize_chunk((torch.as_tensor(pos), torch.as_tensor(boxes)),
                              hist, rmax)
    jg = np.asarray(JR.rdf_frames(jnp.asarray(pos.reshape(-1, 108, 3)),
                                  jnp.asarray(boxes.reshape(-1, 3)), nbins,
                                  rmax)).reshape(nrec, r, nbins)
    want_g = j_slot_order(jg, hist).mean(axis=0)
    want_b = j_slot_order(boxes, hist).mean(axis=0)
    assert g.shape == (r, nbins) and g.dtype == np.float32
    np.testing.assert_allclose(g, want_g, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(b, want_b)
    # the pair counts behind each frame's g are equal
    jc = np.stack([np.asarray(JR.rdf_hist(jnp.asarray(p), jnp.asarray(bx),
                                          nbins, rmax)[1])
                   for p, bx in zip(pos.reshape(-1, 108, 3),
                                    boxes.reshape(-1, 3))])
    tc = TRDF._pair_counts(torch.as_tensor(pos.reshape(-1, 108, 3)),
                           torch.as_tensor(boxes.reshape(-1, 3)), nbins,
                           rmax, 1 << 20)
    np.testing.assert_array_equal(tc.numpy(), jc)


def test_nominal_attempts_and_first_chunk_excess_match_jax_formulas():
    cfg = tiny_cfg()
    setup = TR.setup_run(cfg, engine="cellmc", device="cpu")
    setup = dataclasses.replace(setup, states=setup.states.replace(
        sweep=torch.full_like(setup.states.sweep, 24)))
    box0 = setup.states.box[0].numpy()
    g = JCM.make_geom(box0, 2.5, setup.natoms)
    ncyc, ncolors = JSC.default_ncyc(g), g.stride ** 3
    want = int(8 * 24 * (ncyc * ncolors * (g.ncells // ncolors) * g.nsub
                         + JRUN.nvol_per_sweep(cfg, setup.natoms)
                         / cfg.vol_every))
    assert NS.nominal_attempts(setup) == want > 0

    log = [{"attempt": 1, "kernel": 9.0}, {"attempt": 1, "kernel": 2.0},
           {"attempt": 1, "kernel": 2.5}, {"attempt": 2, "kernel": 6.0},
           {"attempt": 2, "kernel": 1.5}, {"attempt": 3, "kernel": 1.0}]
    # northstar2.py:372-391 on the same log
    firsts = {}
    for c in log:
        firsts.setdefault(c["attempt"], c)
    rest = [c["kernel"] for c in log if c is not firsts.get(c["attempt"])]
    steady = float(np.median(rest))
    want = float(sum(max(0.0, f["kernel"] - steady)
                     for f in firsts.values()))
    assert NS.first_chunk_excess(log) == want == 9.0 - 2.0 + 6.0 - 2.0
    assert NS.first_chunk_excess(log[:2]) == 0.0


def _files(state):
    out = {}
    for name in sorted(os.listdir(state)):
        if name.endswith(".npz") and name != "ck.npz":
            with np.load(os.path.join(state, name)) as z:
                out[name] = {k: z[k] for k in z.files}
    return out


def test_resume_is_bit_for_bit(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = tiny_cfg()
    whole = NS.run(cfg, "whole", "whole.json", ck_secs=0, device="cpu",
                   **SCHED)

    calls = []
    sample = TR.run_sampling

    def stop_in_third_chunk(*a, **kw):
        calls.append(1)
        if len(calls) == 3:           # eq 0, samp 0, then samp 1
            raise KeyboardInterrupt("stopped in the second samp chunk")
        return sample(*a, **kw)

    monkeypatch.setattr(TR, "run_sampling", stop_in_third_chunk)
    with pytest.raises(KeyboardInterrupt):
        NS.run(cfg, "part", "part.json", ck_secs=0, device="cpu", **SCHED)
    with open(tmp_path / "part" / "progress.json") as f:
        prog = json.load(f)
    assert (prog["eq_done"], prog["samp_done"]) == (1, 1)
    assert not (tmp_path / "part.json").exists()
    monkeypatch.setattr(TR, "run_sampling", sample)
    resumed = NS.run(cfg, "part", "part.json", ck_secs=0, device="cpu",
                     **SCHED)

    assert resumed["attempts_to_complete"] == 2
    assert whole["attempts_to_complete"] == 1
    assert resumed["diag"] == whole["diag"] == 0
    assert resumed["tm_by_pressure"] == whole["tm_by_pressure"]
    assert resumed["sweeps_total"] == whole["sweeps_total"] == 24
    assert (resumed["attempted_moves_nominal"]
            == whole["attempted_moves_nominal"])
    a, b = _files(tmp_path / "whole"), _files(tmp_path / "part")
    assert sorted(a) == ["feat_000.npz", "feat_001.npz", "sq.npz"]
    assert sorted(a) == sorted(b)
    for name in a:
        for k in a[name]:
            np.testing.assert_array_equal(b[name][k], a[name][k],
                                          err_msg=f"{name}:{k}")
    assert np.isfinite(list(whole["tm_by_pressure"].values())).all()
    assert sorted(os.listdir(tmp_path)) == ["part", "part.json", "whole",
                                            "whole.json"]


def test_stale_state_is_wiped(tmp_path):
    state = tmp_path / "st"
    state.mkdir()
    stale = {"eq_done": 3, "samp_done": 0, "eq_secs": 5.0, "samp_secs": 0.0,
             "attempts": 4, "chunk_log": [],
             "chunking": {"eq_chunks": 30, "samp_chunks": 2, "records": 1,
                          "mod": 4, "grid": [2, 4]}}
    (state / "progress.json").write_text(json.dumps(stale))
    (state / "feat_000.npz").write_bytes(b"old")
    assert NS.run(tiny_cfg(), str(state), str(tmp_path / "r.json"),
                  preflight_only=True, device="cpu", **SCHED) is None
    assert sorted(os.listdir(state)) == ["progress.json"]
    prog = json.loads((state / "progress.json").read_text())
    assert prog["attempts"] == 1 and prog["eq_done"] == 0
    assert prog["eq_secs"] == 0.0
    assert prog["chunking"] == {"eq_chunks": 1, "samp_chunks": 2,
                                "records": 2, "mod": 4, "grid": [2, 4]}
    # the same chunking is kept
    (state / "feat_000.npz").write_bytes(b"kept")
    NS.run(tiny_cfg(), str(state), str(tmp_path / "r.json"),
           preflight_only=True, device="cpu", **SCHED)
    assert (state / "feat_000.npz").read_bytes() == b"kept"


def test_main_writes_only_under_its_paths(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert NS.main(["--fast", "--preflight-only", "--device", "cpu"]) is None
    assert sorted(str(p.relative_to(tmp_path))
                  for p in tmp_path.rglob("*")) == [
        "output", "output/ns_state_torch_fast",
        "output/ns_state_torch_fast/progress.json"]
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        NS.main(["--fast", "--preflight-only", "--state", "elsewhere"])
    assert not (tmp_path / "elsewhere").exists()
