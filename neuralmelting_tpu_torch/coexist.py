"""Two-phase coexistence melting point, the interface method
(counterpart of ``neuralmelting_tpu.coexist``).

A box prepared half solid / half liquid already holds the solid-liquid
interface, so below T_m the solid grows and above it the liquid does:
no nucleation barrier separates the phases, and a temperature scan
brackets T_m itself rather than the heating/cooling hysteresis around it.

1. ``prep_liquid`` melts a half-sized box well above T_m and holds it
   near the expected T_m (an NPT ensemble of one replica).
2. ``splice_two_phase`` puts a half-supercell lattice in x < Lx/2 and
   the molten configuration, affinely remapped, in [Lx/2 + gap,
   Lx - gap]; ``tile_liquid`` fills the whole box with two copies of it.
3. ``build_coexist_setup`` makes a 3-row ensemble at one pressure (row 0
   pure solid, row 1 pure liquid, row 2 two-phase) over one temperature
   grid; ``runner.run_sampling(exchange=False)`` advances it (a
   tempering swap would carry a melted interface into a colder row).
4. ``liquid_fraction`` reads the two-phase row's PE/atom against the
   pure rows at the same T (the lever rule); ``classify_series`` and
   ``classify_rows`` turn the tail of that series into frozen, melted
   and unresolved temperatures and the bracket [max frozen T, min
   melted T].

The numpy functions take the JAX package's f64/f32 steps, so their
results are the same bits. The two set-up functions run on the port's
runner on ``device`` (the card unless the caller passes "cpu").
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

import torch

from neuralmelting_tpu_torch import runner
from neuralmelting_tpu_torch.config import ELEMENTS, RunConfig
from neuralmelting_tpu_torch.models.lattice import make_supercell

ROW_SOLID, ROW_LIQUID, ROW_TWOPHASE = 0, 1, 2
NROWS = 3


def splice_two_phase(solid_pos: np.ndarray, liquid_pos: np.ndarray,
                     liquid_box: np.ndarray, box: np.ndarray,
                     axis: int = 0, gap: float = 0.5) -> np.ndarray:
    """Compose a two-phase configuration inside ``box``.

    ``solid_pos`` must already live in the lower half of ``box`` along
    ``axis`` (e.g. a half-supercell lattice). ``liquid_pos`` (in its own
    periodic ``liquid_box``) is wrapped, then affinely remapped to fill
    the upper half minus a ``gap`` margin at BOTH seams — the periodic
    seam at coordinate 0/L is a solid-liquid interface too, and lattice
    planes sit exactly at 0, so without the margin a liquid atom at
    L - eps would overlap a solid atom at 0. With it, every cross-seam
    pair satisfies r >= gap and the worst initial pair energy is finite
    (LJ at r = 0.5 sigma is ~1.6e4 eps — f32-safe and annealed away by
    the first relaxation sweeps). Transverse axes rescale to the target
    box exactly (their periodicity is shared with the solid half).
    """
    solid_pos = np.asarray(solid_pos, np.float64)
    liquid_pos = np.asarray(liquid_pos, np.float64)
    liquid_box = np.asarray(liquid_box, np.float64)
    box = np.asarray(box, np.float64)
    half = box[axis] / 2.0
    if np.max(solid_pos[:, axis]) >= half:
        raise ValueError("solid half must lie below box[axis]/2")
    if not (0.0 < 2.0 * gap < half):
        raise ValueError(f"gap {gap} does not fit the half-box {half}")
    liq = np.mod(liquid_pos, liquid_box)
    scale = box / liquid_box
    mapped = liq * scale
    span = box[axis] - half - 2.0 * gap
    mapped[:, axis] = half + gap + liq[:, axis] * (span / liquid_box[axis])
    return np.concatenate([solid_pos, mapped], axis=0).astype(np.float32)


def tile_liquid(liquid_pos: np.ndarray, liquid_box: np.ndarray,
                box: np.ndarray, axis: int = 0) -> np.ndarray:
    """Fill ``box`` with two copies of a half-box liquid along ``axis``
    (the pure-liquid reference row's initial condition; NPT MC
    decorrelates the duplicated halves during relaxation)."""
    liquid_box = np.asarray(liquid_box, np.float64)
    box = np.asarray(box, np.float64)
    liq = np.mod(np.asarray(liquid_pos, np.float64), liquid_box)
    scale = box / liquid_box
    scale[axis] = (box[axis] / 2.0) / liquid_box[axis]
    a = liq * scale
    b = a.copy()
    b[:, axis] += box[axis] / 2.0
    return np.concatenate([a, b], axis=0).astype(np.float32)


def prep_liquid(element: str, ncells, temp_melt: float, temp_hold: float,
                press: float, seed: int = 31, mod: int = 20,
                melt_records: int = 5, hold_records: int = 3,
                setfl: Optional[str] = None, device="cuda"):
    """Equilibrate a liquid in a small periodic box: melt well above
    T_m, then hold near it so the density and structure handed to the
    splice are representative. Returns (pos (N,3), box (3,)) on host."""
    el = ELEMENTS[element]
    cfg = RunConfig(name="coexist-prep", element=element,
                    ncells=tuple(int(n) for n in ncells),
                    npress=1, ntemp=1, press=(float(press),),
                    temp=(float(temp_melt),), nsmpl=1, mod=mod, ncut=0,
                    seed=seed, dpos0=0.08 * el.lat_const,
                    dvol0=0.004)
    setup = runner.setup_run(cfg, setfl=setfl, engine="cellmc",
                             device=device)
    setup, *_rest, diag = runner.run_sampling(
        setup, write_files=False, write_traj=False,
        nrecords=melt_records, exchange=False)
    if int(diag) != 0:
        raise RuntimeError(f"coexist prep melt leg diag={int(diag)}")
    # cool to the hold temperature (the liquid persists — undercooled
    # LJ/EAM liquids survive far below T_m at these sweep budgets)
    t_hold = torch.full_like(setup.t_grid, float(temp_hold))
    setup = dataclasses.replace(
        setup, t_grid=t_hold,
        states=setup.states.replace(temp=t_hold[setup.slot_of.long()]))
    setup, *_rest, diag = runner.run_sampling(
        setup, write_files=False, write_traj=False,
        nrecords=hold_records, exchange=False)
    if int(diag) != 0:
        raise RuntimeError(f"coexist prep hold leg diag={int(diag)}")
    return (setup.states.pos[0].cpu().numpy(),
            setup.states.box[0].cpu().numpy())


def build_coexist_setup(element: str, ncells, temps: Sequence[float],
                        press: float, liquid_pos: np.ndarray,
                        liquid_box: np.ndarray, seed: int = 47,
                        mod: int = 20, gap: float = 0.5,
                        setfl: Optional[str] = None,
                        axis: int = 0, device="cuda"):
    """Build the 3-row coexistence ensemble (solid / liquid / two-phase
    over one temperature grid at one pressure) on the cellmc engine.

    ``ncells[axis]`` must be even (the splice plane lies between cells).
    Rows ride the npress axis of the ordinary (P, T) ensemble — three
    copies of the same pressure — so every runner facility (records,
    checkpointing, adaptation, slab maintenance) applies unchanged; only
    tempering must stay off (run with exchange=False).
    """
    el = ELEMENTS[element]
    ncells = tuple(int(n) for n in ncells)
    if ncells[axis] % 2 != 0:
        raise ValueError("ncells[axis] must be even for the splice plane")
    ntemp = len(temps)
    cfg = RunConfig(name="coexist", element=element, ncells=ncells,
                    npress=NROWS, ntemp=ntemp,
                    press=(float(press),) * NROWS,
                    temp=tuple(float(t) for t in temps),
                    nsmpl=1, mod=mod, ncut=0, seed=seed,
                    dpos0=0.07 * el.lat_const, dvol0=0.004)
    setup = runner.setup_run(cfg, setfl=setfl, engine="cellmc",
                             device=device)
    box0 = setup.states.box[0].cpu().numpy()

    half_cells = list(ncells)
    half_cells[axis] //= 2
    solid_half, _hbox = make_supercell(el.lattice, el.lat_const,
                                       tuple(half_cells))
    n_half = len(solid_half)
    if 2 * n_half != setup.natoms or len(liquid_pos) != n_half:
        raise ValueError(
            f"atom bookkeeping: natoms={setup.natoms}, half lattice "
            f"{n_half}, liquid {len(liquid_pos)}")

    two_phase = splice_two_phase(solid_half, liquid_pos, liquid_box,
                                 box0, axis=axis, gap=gap)
    liquid_full = tile_liquid(liquid_pos, liquid_box, box0, axis=axis)

    # slot s holds (row = s // ntemp, T = temps[s % ntemp]); at setup
    # slot_of is the identity, so replica index == slot index here.
    pos = setup.states.pos.cpu().numpy().copy()
    r0 = ROW_LIQUID * ntemp
    pos[r0:r0 + ntemp] = liquid_full[None]
    r0 = ROW_TWOPHASE * ntemp
    pos[r0:r0 + ntemp] = two_phase[None]
    states = setup.states.replace(
        pos=torch.as_tensor(pos, device=setup.device))
    setup = dataclasses.replace(setup, states=states)
    # re-bin + recompute energies/caches from the injected positions
    return runner._rebind_cellmc(setup, setup.geom)


def row_pe_per_atom(recs_pe: np.ndarray, hist: np.ndarray, natoms: int,
                    ntemp: int) -> np.ndarray:
    """(nrec, R) replica-ordered record PE + replica->slot map ->
    (NROWS, ntemp) chunk-mean PE/atom in slot order. exchange=False
    keeps hist the identity, but reorder anyway — cheap and safe."""
    nrec, r = recs_pe.shape
    out = np.empty((nrec, r), np.float64)
    rows = np.arange(nrec)[:, None]
    out[rows, hist] = recs_pe
    return out.mean(axis=0).reshape(NROWS, ntemp) / natoms


def liquid_fraction(pe_rows: np.ndarray) -> np.ndarray:
    """Lever rule on PE/atom: x = (pe_2ph - pe_solid)/(pe_liq - pe_solid)
    per temperature. pe_rows is (NROWS, ntemp)."""
    sol, liq, two = (pe_rows[ROW_SOLID], pe_rows[ROW_LIQUID],
                     pe_rows[ROW_TWOPHASE])
    den = liq - sol
    den = np.where(np.abs(den) < 1e-12, np.nan, den)
    return (two - sol) / den


def classify_series(temps: Sequence[float], pe_series: np.ndarray,
                    frozen_below: float = 0.25, melted_above: float = 0.75,
                    collapse_frac: float = 0.4):
    """Classify from the full chunk series (nchunk, NROWS, ntemp) of
    PE/atom, guarding the lever rule against reference-row collapse.

    The pure-phase rows are only references while each phase is
    METASTABLE at that T. Outside the mutual metastability window the
    reference itself transforms — the pure solid melts well above T_m,
    the pure liquid freezes well below — and the branch gap collapses,
    sending the lever-rule fraction to garbage (observed: x = -670 on
    the toy run). But a collapsed reference is itself a classification:

      * solid reference melted at T  =>  T > T_heat >= T_m  =>  melted
      * liquid reference froze at T  =>  T < T_cool <= T_m  =>  frozen

    Collapse detection: the branch drifted by more than
    ``collapse_frac`` of the initial branch gap from its own first
    measured chunk (the injected initial conditions are solid/liquid by
    construction, so chunk 0 branches are honest).
    """
    s = np.asarray(pe_series, np.float64)       # (nc, NROWS, ntemp)
    if s.ndim != 3 or s.shape[1] != NROWS:
        raise ValueError(f"pe_series shape {s.shape}")
    nc = s.shape[0]
    tail_n = max(1, min(5, nc // 2))
    tail = s[-tail_n:].mean(axis=0)
    gap0 = s[0, ROW_LIQUID] - s[0, ROW_SOLID]   # per-T initial gap
    drift_s = tail[ROW_SOLID] - s[0, ROW_SOLID]
    drift_l = tail[ROW_LIQUID] - s[0, ROW_LIQUID]
    solid_melted = drift_s > collapse_frac * gap0
    liquid_froze = drift_l < -collapse_frac * gap0
    x = liquid_fraction(tail)
    # collapsed-reference rows override the (meaningless) lever rule
    x = np.where(solid_melted & ~liquid_froze, 1.0, x)
    x = np.where(liquid_froze & ~solid_melted, 0.0, x)
    # both references transformed: the row carries no signal at all
    x = np.where(liquid_froze & solid_melted, np.nan, x)
    res = classify_rows(temps, x, frozen_below, melted_above)
    res["solid_ref_melted"] = [bool(b) for b in solid_melted]
    res["liquid_ref_froze"] = [bool(b) for b in liquid_froze]
    res["tail_chunks"] = int(tail_n)
    return res


def classify_rows(temps: Sequence[float], frac_tail: np.ndarray,
                  frozen_below: float = 0.25, melted_above: float = 0.75):
    """Tail liquid fractions -> {frozen, melted, unresolved} and the
    coexistence bracket. ``consistent`` demands every frozen T sit below
    every melted T — a violated ordering means the tail window is too
    noisy to claim a bracket, and the caller should run longer rather
    than report it."""
    t = np.asarray(temps, np.float64)
    x = np.asarray(frac_tail, np.float64)
    frozen = x < frozen_below
    melted = x > melted_above
    unresolved = ~(frozen | melted)
    lo = float(t[frozen].max()) if frozen.any() else None
    hi = float(t[melted].min()) if melted.any() else None
    consistent = (lo is None) or (hi is None) or (lo < hi)
    return {
        "frozen_temps": t[frozen].tolist(),
        "melted_temps": t[melted].tolist(),
        "unresolved_temps": t[unresolved].tolist(),
        "liquid_fraction": x.tolist(),
        "bracket": [lo, hi],
        "consistent": bool(consistent),
    }
