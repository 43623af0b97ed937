"""Resumable north-star run (counterpart of ``scripts/northstar2.py``):
32x32 (P, T) x 4096-atom LJ NPT MC -> g(r) -> classifier -> T_m(P), with
(P, T)-points/hour.

    python -m neuralmelting_tpu_torch.northstar [--fast] [--preflight-only]
        [--ck-secs S] [--cool] [--state DIR] [--out PATH] [--device]

The heating leg starts every replica from the lattice: 6 equilibration
chunks, then 4 sampled chunks, each chunk 5 records x 20 sweeps (600 +
400 sweeps; ``--fast``: 4x4x4 cells, a 4x8 grid, 1 + 2 chunks of 2
records). Every sampled chunk's g(r) (64 bins) is slot-ordered, averaged
over its records and stored; a CNN trained on extreme-T labels (400
epochs) then gives P(liquid) per slot and a logistic fit T_m per
pressure.

The run resumes. Counters live in ``<state>/progress.json``, and the
ensemble in ``<state>/ck.npz`` (``io/checkpoint.py`` with
``runner.checkpoint_extras``: slabs and grid shift, and the host draws
follow from the seed and the sweep counter, so a resumed run continues
the same chain). A checkpoint is written when
``--ck-secs`` of wall have passed since the last one and at the end of
each stage; the counters advance only with a saved checkpoint, so a
stopped run repeats the chunks after its last one. A state written under
another chunking is wiped (the stale-vintage guard). Timing accumulates
over attempts, so points/hour counts the compute actually spent.

``first_chunk_excess_seconds`` is the excess of each attempt's first
chunk over the median of the others: on the card, the kernels' nvcc
build at their first launch and the CUDA warm-up (the JAX script's
``xla_compile_seconds`` counted its XLA compile there).
``points_per_hour_steady`` leaves it out.

``--cool`` adds the cooling leg: every replica takes the configuration
of the hottest slot at its pressure (molten), re-equilibrates and is
sampled as above, and the heating leg's classifier, not retrained, gives
T_cool per pressure; rows whose probabilities do not cross 0.5 inside
the grid are censored (null). ``--preflight-only`` runs g(r) of one
synthetic frame a replica and stops.

Runs on the card unless given ``--device cpu``; without a GPU the
default raises. Writes only under ``--state`` (default
``output/ns_state_torch[_fast]``) and ``--out`` (default
``output/northstar_result_torch[_fast].json``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from neuralmelting_tpu_torch import runner
from neuralmelting_tpu_torch.config import RunConfig
from neuralmelting_tpu_torch.features.rdf import rdf_frames, structure_factor
from neuralmelting_tpu_torch.io import checkpoint as ckpt_mod
from neuralmelting_tpu_torch.neural.melt import (crossing_resolved,
                                                 melting_curve)
from neuralmelting_tpu_torch.neural.models import PhaseCNN, init_params
from neuralmelting_tpu_torch.neural.scalers import get_scaler
from neuralmelting_tpu_torch.neural.train import (extreme_t_labels, full_f32,
                                                  train_classifier)
from neuralmelting_tpu_torch.pipeline import slot_order_features
from neuralmelting_tpu_torch.sampler import cellmc as SC

NBINS = 64
EPOCHS = 400
ANCHOR = 0.780      # T*(P*=1) of the CPU reference (docs/VALIDATION.md)


def make_cfg(fast: bool = False) -> RunConfig:
    npress, ntemp = (4, 8) if fast else (32, 32)
    return RunConfig(
        name="northstar", element="LJ",
        ncells=(4, 4, 4) if fast else (16, 8, 8),
        npress=npress, ntemp=ntemp,
        press=tuple(float(p) for p in np.linspace(1.0, 5.0, npress)),
        temp=tuple(float(t) for t in np.linspace(0.55, 1.55, ntemp)),
        nsmpl=1, mod=20, ncut=0, seed=7, dpos0=0.11, dvol0=0.004)


def schedule(fast: bool = False) -> dict:
    """Chunks of each stage and records (x ``cfg.mod`` sweeps) a chunk."""
    return ({"eq_chunks": 1, "samp_chunks": 2, "records": 2} if fast
            else {"eq_chunks": 6, "samp_chunks": 4, "records": 5})


def load_progress(state: str) -> dict:
    p = os.path.join(state, "progress.json")
    if os.path.exists(p):
        with open(p) as f:
            return json.load(f)
    return {"eq_done": 0, "samp_done": 0,
            "eq_secs": 0.0, "samp_secs": 0.0, "attempts": 0,
            "kernel_secs": 0.0, "feat_secs": 0.0, "ck_secs": 0.0,
            "ck_count": 0, "chunk_log": []}


def save_progress(state: str, prog: dict):
    p = os.path.join(state, "progress.json")
    tmp = p + ".tmp"
    with open(tmp, "w") as f:
        json.dump(prog, f)
    os.replace(tmp, p)


class Checkpointer:
    """Time-based checkpoints: save when ``ck_secs`` of wall have passed
    since the last save, or when forced at a stage boundary. Progress
    counters advance only alongside a saved checkpoint, so a stopped run
    resumes from a consistent (state, counters) pair."""

    def __init__(self, prog: dict, state: str, ck_secs: float):
        self.prog = prog
        self.state = state
        self.ck_secs = ck_secs
        self.last = time.perf_counter()
        self.pending = {}

    def note(self, **updates):
        """Stage the progress-counter updates for the next save."""
        self.pending.update(updates)

    def maybe(self, setup, force=False) -> float:
        if not force and time.perf_counter() - self.last < self.ck_secs:
            return 0.0
        t0 = time.perf_counter()
        path = os.path.join(self.state, "ck.npz")
        ckpt_mod.save(path + ".tmp.npz", setup.states, setup.slot_of,
                      setup.cfg.to_json(), runner.checkpoint_extras(setup))
        os.replace(path + ".tmp.npz", path)
        dt = time.perf_counter() - t0
        self.prog.update(self.pending)
        self.prog["ck_secs"] = self.prog.get("ck_secs", 0.0) + dt
        self.prog["ck_count"] = self.prog.get("ck_count", 0) + 1
        save_progress(self.state, self.prog)
        self.pending = {}
        self.last = time.perf_counter()
        return dt


def preflight(r: int, natoms: int, rmax: float, device) -> float:
    """g(r) of one synthetic frame a replica at the run's sizes, so that
    a featurization that cannot run fails before the sampling."""
    gen = torch.Generator(device=device).manual_seed(0)
    pos = torch.rand((r, natoms, 3), generator=gen, device=device) * 10.0
    boxes = torch.full((r, 3), 10.0, device=device)
    t0 = runner.timed(device)
    g = rdf_frames(pos, boxes, NBINS, rmax)
    finite = bool(torch.isfinite(g).all())
    dt = runner.timed(device) - t0
    print(f"preflight: rdf_frames({r}x{natoms}) ok in {dt:.1f}s "
          f"finite={finite}", file=sys.stderr)
    return dt


def featurize_chunk(frames, hist, rmax: float):
    """(nrec, R, N, 3) and (nrec, R, 3) frames on the device, hist (nrec,
    R) -> the slot-ordered chunk means of g (R, NBINS) and box (R, 3) on
    the host."""
    pos, boxes = frames
    nrec, r = hist.shape
    g = rdf_frames(pos.reshape(nrec * r, -1, 3), boxes.reshape(nrec * r, 3),
                   NBINS, rmax)
    g_slot = slot_order_features(g.cpu().numpy().reshape(nrec, r, NBINS),
                                 hist)
    b_slot = slot_order_features(boxes.cpu().numpy(), hist)
    return g_slot.mean(axis=0), b_slot.mean(axis=0)


def saved_features(state: str, nchunks: int):
    """The mean g(r) (R, NBINS) and box (R, 3) over the ``nchunks``
    sampled chunks' ``feat_NNN.npz`` in ``state``, as numpy."""
    gs, bs = [], []
    for i in range(nchunks):
        with np.load(os.path.join(state, f"feat_{i:03d}.npz")) as z:
            gs.append(z["g"])
            bs.append(z["box"])
    return np.mean(gs, axis=0), np.mean(bs, axis=0)


def classify(temp, feats, npress, ntemp, epochs: int = EPOCHS,
             seed: int = 3):
    """The classifier (tanh scaler, CNN from initial-weight ``seed``,
    extreme-T labels of band ntemp // 8) trained on feats (R, NBINS), and
    the logistic T_m fit. Returns (tms, widths, probs (npress, ntemp),
    (net, params, fitted scaler))."""
    sc = get_scaler("tanh")
    x = sc.fit_transform(feats)
    band = max(1, ntemp // 8)
    mask1, labels1 = extreme_t_labels(ntemp, band, device=feats.device)
    net = PhaseCNN(feats.shape[1]).to(feats.device)
    init_params(net, torch.Generator().manual_seed(seed))
    res = train_classifier(net, x, mask1.repeat(npress),
                           labels1.repeat(npress), epochs=epochs, lr=2e-3)
    probs = res.probs.cpu().numpy().reshape(npress, ntemp)
    tms, widths = melting_curve(temp, probs)
    return tms, widths, probs, (net, res.params, sc)


def train_and_fit(setup, feats, box_mean, npress, ntemp, natoms, rmax,
                  epochs: int = EPOCHS):
    """Classifier (extreme-T labels) and logistic T_m fit. Returns (tms,
    widths, resolved, (q, sq), (net, params, fitted scaler))."""
    q, sq = structure_factor(feats, box_mean, natoms, rmax)
    tms, widths, probs, clf = classify(setup.temp, feats, npress, ntemp,
                                       epochs)
    resolved = crossing_resolved(setup.temp, probs, tms)
    return (tms, widths, resolved, (q.cpu().numpy(), sq.cpu().numpy()),
            clf)


def apply_and_fit(setup, clf, feats, npress, ntemp):
    """Apply the heating leg's trained classifier to new features (the
    cooling leg must not retrain: extreme-T labels are invalid on a
    liquid start). Returns (tms, widths, resolved, probs)."""
    net, _params, sc = clf
    with torch.no_grad(), full_f32():
        probs = torch.sigmoid(net(sc.transform(feats)))
    probs = probs.cpu().numpy().reshape(npress, ntemp)
    tms, widths = melting_curve(setup.temp, probs)
    resolved = crossing_resolved(setup.temp, probs, tms)
    return tms, widths, resolved, probs


def nominal_attempts(setup) -> int:
    """Attempted moves over the run's sweeps: position attempts of every
    colour step and volume trials, all replicas."""
    g, cfg = setup.geom, setup.cfg
    r = int(setup.states.temp.shape[0])
    ncolors = g.stride ** 3
    sweeps = int(setup.states.sweep[0])
    return int(r * sweeps
               * (SC.default_ncyc(g) * ncolors * (g.ncells // ncolors)
                  * g.nsub
                  + runner.nvol_per_sweep(cfg, setup.natoms)
                  / cfg.vol_every))


def first_chunk_excess(chunk_log) -> float:
    """Excess of each attempt's first chunk over the median of the other
    chunks, summed over attempts (0 with fewer than 3 chunks)."""
    if len(chunk_log) < 3:
        return 0.0
    firsts = {}
    for c in chunk_log:
        firsts.setdefault(c["attempt"], c)
    rest = [c["kernel"] for c in chunk_log
            if c is not firsts.get(c["attempt"])]
    if not rest:
        return 0.0
    steady = float(np.median(rest))
    return float(sum(max(0.0, f["kernel"] - steady)
                     for f in firsts.values()))


def cool_leg(setup, clf, eq_chunks, samp_chunks, records, rmax, state,
             diag_any):
    """Re-start every replica from the molten configuration of the
    hottest slot at its pressure, re-equilibrate and sample as the heating
    leg, and apply its classifier. Returns (setup, tms, resolved,
    seconds, chunk log, diag)."""
    dev = setup.device
    t_start = runner.timed(dev)
    npress, ntemp = len(setup.press), len(setup.temp)
    r = npress * ntemp
    slot_np = setup.slot_of.cpu().numpy()              # replica -> slot
    rep_of_slot = np.argsort(slot_np)                  # slot -> replica
    hot = rep_of_slot[(np.arange(r) // ntemp) * ntemp + (ntemp - 1)]
    # replica i (holding slot s) takes the configuration of the replica
    # holding (P(s), T_max)
    donor = torch.as_tensor(hot[slot_np], dtype=torch.long, device=dev)
    states = setup.states.replace(pos=setup.states.pos[donor],
                                  box=setup.states.box[donor])
    setup = runner._rebind_cellmc(
        dataclasses.replace(setup, states=states), setup.geom)
    print("cool: donor injection and rebind done", file=sys.stderr)
    log = []
    gs, bs = [], []
    for phase, n in (("cool_eq", eq_chunks), ("cool_samp", samp_chunks)):
        for i in range(n):
            t0 = time.perf_counter()
            setup, _recs, frames, hist, _xacc, diag = runner.run_sampling(
                setup, write_files=False, write_traj=phase == "cool_samp",
                nrecords=records)
            diag_any |= int(diag)
            if phase == "cool_samp":
                g, b = featurize_chunk(frames, hist.cpu().numpy(), rmax)
                gs.append(g)
                bs.append(b)
            runner.timed(dev)
            log.append({"phase": phase, "i": i,
                        "kernel": round(time.perf_counter() - t0, 2)})
            print(f"{phase} chunk {i}: {log[-1]['kernel']:.1f}s "
                  f"diag={int(diag)}", file=sys.stderr)
    feats = torch.as_tensor(np.mean(gs, axis=0), dtype=torch.float32,
                            device=dev)
    tms, _w, resolved, probs = apply_and_fit(setup, clf, feats, npress,
                                             ntemp)
    np.savez(os.path.join(state, "cool_probs.npz"), probs=probs, tms=tms,
             resolved=resolved)
    return (setup, tms, resolved, runner.timed(dev) - t_start, log,
            diag_any)


def run(cfg: RunConfig, state: str, out: str, eq_chunks: int,
        samp_chunks: int, records: int, ck_secs: float = 240.0,
        cool: bool = False, preflight_only: bool = False, device="cuda"):
    """One attempt of the north-star run of ``cfg``, resuming from
    ``state``; writes the result to ``out`` and returns it (None after
    ``preflight_only``)."""
    dev = runner.resolve_device(device)
    os.makedirs(state, exist_ok=True)
    npress, ntemp = cfg.npress, cfg.ntemp
    r = npress * ntemp

    prog = load_progress(state)
    # progress counters mean something only under the chunking that
    # wrote them: a state from another chunking would skip stages and
    # report its timings as this run's
    sig = {"eq_chunks": eq_chunks, "samp_chunks": samp_chunks,
           "records": records, "mod": cfg.mod, "grid": [npress, ntemp]}
    if (prog["eq_done"] or prog["samp_done"]) and prog.get("chunking") != sig:
        print(f"stale state (chunking {prog.get('chunking')} != {sig}); "
              f"starting fresh", file=sys.stderr)
        for f in os.listdir(state):
            os.remove(os.path.join(state, f))
        prog = load_progress(state)
    prog["chunking"] = sig
    prog["attempts"] += 1
    save_progress(state, prog)

    setup = runner.setup_run(cfg, engine="cellmc", device=dev)
    natoms = setup.natoms
    rmax = 0.48 * float(torch.min(setup.states.box[0]))

    pf_secs = preflight(r, natoms, rmax, dev)
    if preflight_only:
        return None

    if prog["eq_done"] > 0 or prog["samp_done"] > 0:
        setup = runner.restore_setup(setup, os.path.join(state, "ck.npz"))
        print(f"resumed: eq_done={prog['eq_done']} "
              f"samp_done={prog['samp_done']} "
              f"attempt={prog['attempts']}", file=sys.stderr)

    diag_any = int(prog.get("diag", 0))
    cker = Checkpointer(prog, state, ck_secs)
    attempt = prog["attempts"]

    # --- equilibrate (no frames) --------------------------------------
    for i in range(prog["eq_done"], eq_chunks):
        t0 = time.perf_counter()
        setup, recs, _frames, _hist, _xacc, diag = runner.run_sampling(
            setup, write_files=False, write_traj=False, nrecords=records)
        runner.timed(dev)
        diag_any |= int(diag)
        kdt = time.perf_counter() - t0
        prog.setdefault("chunk_log", []).append(
            {"phase": "eq", "i": i, "kernel": round(kdt, 2),
             "attempt": attempt})
        cker.note(eq_done=i + 1, eq_secs=prog["eq_secs"] + kdt,
                  kernel_secs=prog.get("kernel_secs", 0.0) + kdt,
                  chunk_log=prog["chunk_log"], diag=diag_any)
        prog["eq_secs"] += kdt
        prog["kernel_secs"] = prog.get("kernel_secs", 0.0) + kdt
        cdt = cker.maybe(setup, force=(i + 1 == eq_chunks))
        print(f"eq chunk {i}: pe/N="
              f"{float(torch.mean(recs.pe[-1])) / natoms:.3f} "
              f"diag={int(diag)} kernel={kdt:.1f}s ck={cdt:.1f}s",
              file=sys.stderr)

    # --- sample and featurize each chunk ------------------------------
    for i in range(prog["samp_done"], samp_chunks):
        t0 = time.perf_counter()
        setup, _recs, frames, hist, _xacc, diag = runner.run_sampling(
            setup, write_files=False, write_traj=True, nrecords=records)
        runner.timed(dev)
        diag_any |= int(diag)
        kdt = time.perf_counter() - t0
        t1 = time.perf_counter()
        g_slot, b_slot = featurize_chunk(frames, hist.cpu().numpy(), rmax)
        del frames
        fdt = time.perf_counter() - t1
        fp = os.path.join(state, f"feat_{i:03d}.npz")
        np.savez(fp + ".tmp.npz", g=g_slot, box=b_slot)
        os.replace(fp + ".tmp.npz", fp)
        prog.setdefault("chunk_log", []).append(
            {"phase": "samp", "i": i, "kernel": round(kdt, 2),
             "feat": round(fdt, 2), "attempt": attempt})
        cker.note(samp_done=i + 1,
                  samp_secs=prog["samp_secs"] + kdt + fdt,
                  kernel_secs=prog.get("kernel_secs", 0.0) + kdt,
                  feat_secs=prog.get("feat_secs", 0.0) + fdt,
                  chunk_log=prog["chunk_log"], diag=diag_any)
        prog["samp_secs"] += kdt + fdt
        prog["kernel_secs"] = prog.get("kernel_secs", 0.0) + kdt
        prog["feat_secs"] = prog.get("feat_secs", 0.0) + fdt
        cdt = cker.maybe(setup, force=(i + 1 == samp_chunks))
        print(f"samp chunk {i}: kernel={kdt:.1f}s feat={fdt:.1f}s "
              f"ck={cdt:.1f}s diag={int(diag)}", file=sys.stderr)

    # --- classifier (extreme-T labels) and T_m fit --------------------
    t0 = runner.timed(dev)
    g, box = saved_features(state, samp_chunks)
    feats = torch.as_tensor(g, dtype=torch.float32, device=dev)  # (R, NBINS)
    box_mean = torch.as_tensor(box, device=dev)
    tms, _widths, resolved_h, (q, sq), clf = train_and_fit(
        setup, feats, box_mean, npress, ntemp, natoms, rmax)
    np.savez(os.path.join(state, "sq.npz"), q=q, sq=sq)
    train_secs = runner.timed(dev) - t0
    print(f"train+fit done in {train_secs:.1f}s tm_p1={float(tms[0]):.4f}",
          file=sys.stderr)

    compute_secs = prog["eq_secs"] + prog["samp_secs"] \
        + prog.get("ck_secs", 0.0) + train_secs
    clog = prog.get("chunk_log", [])
    excess = first_chunk_excess(clog)
    steady_secs = max(compute_secs - excess, 1e-9)
    attempts = nominal_attempts(setup)
    press = np.asarray(setup.press)
    tm_p1 = float(tms[0])
    err_p1 = abs(tm_p1 / ANCHOR - 1.0)
    result = {
        "grid": [npress, ntemp], "natoms": natoms,
        "sweeps_total": int(setup.states.sweep[0]),
        "attempted_moves_nominal": attempts,
        "diag": diag_any,
        "eq_seconds": round(prog["eq_secs"], 1),
        "sample_seconds": round(prog["samp_secs"], 1),
        "feature_train_seconds": round(train_secs, 1),
        "total_seconds": round(compute_secs, 1),
        "attempts_to_complete": prog["attempts"],
        "preflight_seconds": round(pf_secs, 1),
        "breakdown": {
            "kernel_seconds": round(prog.get("kernel_secs", 0.0), 1),
            "featurize_seconds": round(prog.get("feat_secs", 0.0), 1),
            "checkpoint_seconds": round(prog.get("ck_secs", 0.0), 1),
            "checkpoint_count": prog.get("ck_count", 0),
            "train_seconds": round(train_secs, 1),
            "records_per_chunk": records,
            "first_chunk_excess_seconds": round(excess, 1),
            "chunk_log": clog,
        },
        "moves_per_sec_nominal": attempts / max(
            prog["eq_secs"] + prog["samp_secs"], 1e-9),
        "points_per_hour": r / (compute_secs / 3600.0),
        "points_per_hour_steady": r / (steady_secs / 3600.0),
        "tm_by_pressure": {f"{press[i]:.3f}": float(tms[i])
                           for i in range(npress)},
        "tm_p1": tm_p1, "tm_p1_anchor": ANCHOR,
        "tm_p1_rel_err": err_p1,
        "pass_2pct": bool(err_p1 <= 0.02),
        "heat_resolved_rows": int(np.sum(resolved_h)),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }

    if cool:
        setup, tms2, resolved2, cool_secs, cool_log, diag_any = cool_leg(
            setup, clf, eq_chunks, samp_chunks, records, rmax, state,
            diag_any)
        t_min = float(np.asarray(setup.temp)[0])
        # a cooling row that never refroze on the grid says only T_cool <
        # the lowest T scanned: null, not the extrapolated fit
        tm_cool = [float(tms2[i]) if resolved2[i] else None
                   for i in range(npress)]
        lo0 = tm_cool[0]
        hi0 = float(tms[0])
        result["bracket"] = {
            "tm_heat_by_pressure": {f"{press[i]:.3f}": float(tms[i])
                                    for i in range(npress)},
            "tm_cool_by_pressure": {f"{press[i]:.3f}": tm_cool[i]
                                    for i in range(npress)},
            "cool_resolved_rows": int(np.sum(resolved2)),
            "cool_censored_below": t_min,
            # no check that lo0 <= hi0, as in the JAX script (ROADMAP C3)
            "tm_bracket_p1": [lo0, hi0],
            "bracket_p1_resolved": bool(resolved2[0]),
            "anchor_in_bracket_p1": (
                bool(lo0 - 0.02 <= ANCHOR <= hi0 + 0.02)
                if lo0 is not None else None),
            "anchor_below_heating_edge_p1": bool(ANCHOR <= hi0 + 0.02),
            "cool_seconds": round(cool_secs, 1),
            "cool_chunk_log": cool_log,
            "diag": diag_any,
        }

    print(json.dumps(result, indent=1))
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fast", action="store_true",
                    help="4x4x4 cells, a 4x8 grid, 1 + 2 chunks of 2 records")
    ap.add_argument("--preflight-only", action="store_true")
    ap.add_argument("--ck-secs", type=float, default=240.0,
                    help="seconds of wall between checkpoints")
    ap.add_argument("--cool", action="store_true",
                    help="add the cooling leg")
    ap.add_argument("--state", default=None, help="state directory "
                    "(default output/ns_state_torch[_fast])")
    ap.add_argument("--out", default=None, help="result JSON path "
                    "(default output/northstar_result_torch[_fast].json)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    tag = "_fast" if args.fast else ""
    return run(make_cfg(args.fast),
               args.state or os.path.join("output", "ns_state_torch" + tag),
               args.out or os.path.join("output",
                                        f"northstar_result_torch{tag}.json"),
               ck_secs=args.ck_secs, cool=args.cool,
               preflight_only=args.preflight_only, device=args.device,
               **schedule(args.fast))


if __name__ == "__main__":
    main()
