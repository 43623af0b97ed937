"""Host-side run orchestration: config -> ensemble -> chunks (counterpart of
``neuralmelting_tpu.runner``, its single-process cellmc path, LJ and EAM).

Builds the potential and the replica ensemble from a ``RunConfig`` on a
``device`` (the card unless the caller passes ``device="cpu"``), bins it
into slabs, and advances it in chunks with tempering, geometry
maintenance (kcap hysteresis, cell-grid refresh) and the slab-overflow
retry from a pre-chunk snapshot. LJ runs on stride-2 cells with kernels
B1/B2; EAM ("eam/alloy", element "AL") samples the Chebyshev refit of
its setfl table on stride-3 cells with one mover per cell and a density
slab, kernels B3/B4.

Not here yet, each named with the ROADMAP item that brings it: the
gather/serial engines (A13), the dense engine (A14, not ported), slot
files and checkpoints (A7), coexistence runs without exchange beyond the
plain ``exchange=False`` chunk (A10), multi-GPU (A12). Unlike the JAX
runner there is no compile cache (nothing is traced) and no scoped-VMEM
guard (a TPU compiler limit).
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
import warnings
from typing import Optional

import numpy as np
import torch

from neuralmelting_tpu_torch import units
from neuralmelting_tpu_torch.config import ELEMENTS, RunConfig, grids
from neuralmelting_tpu_torch.models import eam as eam_mod
from neuralmelting_tpu_torch.models import eam_cheb, eam_gen
from neuralmelting_tpu_torch.models.lattice import make_supercell
from neuralmelting_tpu_torch.models.lj import LJCut
from neuralmelting_tpu_torch.ops import cellmc_eam as CE
from neuralmelting_tpu_torch.ops import cellmc_geom as CG
from neuralmelting_tpu_torch.sampler import cellmc as SC
from neuralmelting_tpu_torch.sampler.state import ensemble_init

_LATER = {
    "gather": "ROADMAP A13 (reference-exact engines)",
    "serial": "the JAX runner has none either (ROADMAP A13); one serial "
              "chain runs through sampler/serial.py, see golden.py",
    "dense": "ROADMAP A14 (the dense/MXU engine is not ported)",
}


@dataclasses.dataclass
class RunSetup:
    cfg: RunConfig
    pot: object                # LJCut, or the sampled EAMCheb
    style: str                 # "pair" | "eam"
    us: units.UnitSystem
    press: np.ndarray          # (npress,)
    temp: np.ndarray           # (ntemp,)
    t_grid: torch.Tensor       # (R,) slot temps
    p_grid: torch.Tensor       # (R,) slot pressures
    states: object
    slot_of: torch.Tensor      # (R,) replica -> slot
    natoms: int
    device: torch.device
    gen: torch.Generator       # host draws (volume, rebin, exchange)
    geom: object = None
    slabs: object = None       # (x, y, z, ids[, rho]) leading-R
    slab_count: object = None  # (R, C) int32
    shift: object = None       # (3,) fractional grid shift
    cell_tabs: object = None   # (3, C*K) int32 row tables
    moves_tried: object = None  # () int64: attempted moves, all chunks


def resolve_device(device) -> torch.device:
    """A torch.device; "cuda" without a usable GPU raises (the port never
    moves a run to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def build_potential(cfg: RunConfig, setfl: Optional[str] = None):
    """(potential, style): LJCut and "pair", or the setfl table's
    EAMAlloy and "eam". Without a table the synthetic Al table
    (models/eam_gen.py) is written into the temp directory once."""
    spec = ELEMENTS[cfg.element].potential
    if spec.style == "lj/cut":
        return LJCut.create(spec.eps, spec.sigma, spec.rc), "pair"
    path = setfl or spec.setfl
    if path is None:
        path = os.path.join(tempfile.gettempdir(),
                            "nm_synthetic_Al.eam.alloy")
        if not os.path.exists(path):
            # written under a private name and moved in whole: concurrent
            # first runs never read a half-written table
            tmp = f"{path}.{os.getpid()}.tmp"
            eam_gen.write_setfl(tmp)
            os.replace(tmp, path)
    return eam_mod.load(path), "eam"


def _eam_rho(geom, states, slabs, cheb, dev):
    """Append the density slab to (x, y, z, ids); exact pe/virial."""
    scal, series, _ = CE.eam_pack(cheb, dev)
    states, rho = SC.eam_initial_rho(geom, states, slabs, scal, series)
    return states, tuple(slabs[:4]) + (rho,)


def setup_run(cfg: RunConfig, setfl: Optional[str] = None,
              engine: str = "cellmc", device="cuda") -> RunSetup:
    """The ensemble of ``cfg`` on ``device``, binned into slabs with exact
    energies. ``device`` is the card unless the caller asks for "cpu";
    without a usable GPU the default raises."""
    if engine != "cellmc":
        raise NotImplementedError(
            f"engine {engine!r} is not ported: {_LATER.get(engine, 'unknown engine')}")
    if cfg.phmc > 0:
        raise ValueError(
            f"HMC (phmc={cfg.phmc}) is not offered on the cellmc engine")
    dev = resolve_device(device)
    el = ELEMENTS[cfg.element]
    us = units.get(el.units)
    pot, style = build_potential(cfg, setfl)
    press, temp = grids(cfg)
    npress, ntemp = len(press), len(temp)
    r = npress * ntemp
    t_grid = torch.as_tensor(np.tile(temp, npress), dtype=torch.float32,
                             device=dev)
    p_grid = torch.as_tensor(np.repeat(press, ntemp), dtype=torch.float32,
                             device=dev)
    pos, box = make_supercell(el.lattice, el.lat_const, cfg.ncells)
    n = len(pos)
    states = ensemble_init(pos, box, t_grid, p_grid, dpos0=cfg.dpos0,
                           dvol_frac0=cfg.dvol0, dt0=el.dt, device=dev)
    shift = torch.zeros((3,), dtype=torch.float32, device=dev)
    if style == "pair":
        geom = CG.make_geom(box, pot.rc_host, n)
    else:
        # EAM: the Chebyshev form + stride-3 cells with one mover per cell
        # (2w >= 2rc: exact parallel acceptance of density-coupled moves)
        pot = eam_cheb.from_spline(pot)
        geom = CG.make_geom(box, pot.rc_host, n, nsub=1, stride=3)
    geom, slabs, slab_count, over = _bin_tightened(geom, states, shift)
    if bool(over):
        raise RuntimeError("cell slot capacity overflow at setup; raise kcap")
    if style == "pair":
        states = SC.refresh_energies(geom, states, slabs, pot)
    else:
        states, slabs = _eam_rho(geom, states, slabs, pot, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(cfg.seed))
    return RunSetup(
        cfg=cfg, pot=pot, style=style, us=us, press=press, temp=temp,
        t_grid=t_grid,
        p_grid=p_grid, states=states,
        slot_of=torch.arange(r, dtype=torch.int32, device=dev), natoms=n,
        device=dev, gen=gen, geom=geom, slabs=slabs,
        slab_count=slab_count, shift=shift,
        cell_tabs=torch.as_tensor(CG.geom_tables(geom), device=dev),
        moves_tried=torch.zeros((), dtype=torch.int64, device=dev))


def _bin_tightened(geom, states, shift):
    """Bin the ensemble, tighten kcap to the measured occupancy (sweep cost
    is linear in K), and re-bin if it tightened."""
    slabs, slab_count, over = SC.build_slabs(geom, states, shift)
    kt = CG.tight_kcap(int(torch.max(slab_count)), geom.nsub)
    if kt < geom.kcap:
        geom = dataclasses.replace(geom, kcap=kt)
        slabs, slab_count, over = SC.build_slabs(geom, states, shift)
    return geom, slabs, slab_count, over


def _rebind_cellmc(setup: RunSetup, geom) -> RunSetup:
    """Re-bin the CURRENT ensemble (positions exact at a chunk boundary)
    into slabs for a new geometry; grows kcap once more if the new cap
    still overflows."""
    shift = torch.zeros((3,), dtype=torch.float32, device=setup.device)
    slabs, slab_count, over = SC.build_slabs(geom, setup.states, shift)
    if bool(over):
        geom = dataclasses.replace(
            geom, kcap=CG.tight_kcap(int(torch.max(slab_count)), geom.nsub))
        slabs, slab_count, over = SC.build_slabs(geom, setup.states, shift)
        if bool(over):
            raise RuntimeError("cell slot overflow persists after rebuild")
    if setup.style == "eam":
        states, slabs = _eam_rho(geom, setup.states, slabs, setup.pot,
                                 setup.device)
    else:
        states = SC.refresh_energies(geom, setup.states, slabs, setup.pot)
    return dataclasses.replace(
        setup, geom=geom, slabs=slabs, slab_count=slab_count, shift=shift,
        cell_tabs=torch.as_tensor(CG.geom_tables(geom), device=setup.device),
        states=states)


def _refresh_cellmc_geom(setup: RunSetup) -> RunSetup:
    """Pre-chunk geometry maintenance: re-derive the cell grid from the
    current boxes (cells must keep covering rc) and re-tighten kcap, with
    hysteresis: grow when occupancy is within 4 slots of the cap, shrink
    when the tight cap is 16 below it."""
    g = setup.geom
    minbox = torch.min(setup.states.box, dim=0).values.cpu().numpy()
    ng = CG.make_geom(minbox.astype(np.float64), setup.pot.rc_host,
                      setup.natoms, nsub=g.nsub, stride=g.stride)
    if ng.ncell != g.ncell:
        return _rebind_cellmc(setup, ng)
    maxcount = int(torch.max(setup.slab_count))
    kt = CG.tight_kcap(maxcount, g.nsub)
    if maxcount > g.kcap - 4 or kt <= g.kcap - 16:
        return _rebind_cellmc(setup, dataclasses.replace(g, kcap=kt))
    return setup


def liquid_start(setup: RunSetup, nrecords: int = 5,
                 overheat: float = 1.3) -> RunSetup:
    """Pre-melt the ensemble for a cooling-leg run: sample ``nrecords``
    record blocks with every replica at overheat * max(T grid), then
    restore each replica's slot temperature."""
    t_hot = torch.full_like(setup.t_grid,
                            overheat * float(torch.max(setup.t_grid)))
    hot = dataclasses.replace(
        setup, t_grid=t_hot,
        states=setup.states.replace(temp=t_hot[setup.slot_of.long()]))
    hot, _recs, _frames, _hist, _xacc, diag = run_sampling(
        hot, write_traj=False, nrecords=nrecords)
    if int(diag) != 0:
        warnings.warn(f"liquid_start melt leg finished with diag={int(diag)}",
                      RuntimeWarning, stacklevel=2)
    st = hot.states.replace(temp=setup.t_grid[hot.slot_of.long()])
    return dataclasses.replace(hot, states=st, t_grid=setup.t_grid)


def nvol_per_sweep(cfg: RunConfig, natoms: int) -> int:
    """Volume attempts per sweep from the reference's per-move probability,
    capped so full-energy passes do not dominate at large N."""
    return max(1, min(4, int(round(cfg.pvol * natoms / 32))))


def run_sampling(setup: RunSetup, nrecords: Optional[int] = None,
                 write_traj: bool = True, exchange: bool = True):
    """Advance the ensemble ``nrecords`` record blocks (one chunk).

    Returns (setup, recs, frames, hist, xacc, diag): recs fields (nrec, R)
    replica-ordered, frames (positions (nrec, R, N, 3), boxes (nrec, R, 3))
    or None, hist (nrec, R) the replica -> slot map at each record, xacc
    (nrec,) accepted swaps, diag the chunk's diagnostic bits (int).
    ``exchange=False`` keeps every replica on its slot.
    """
    cfg = setup.cfg
    npress, ntemp = len(setup.press), len(setup.temp)
    nrecords = nrecords or cfg.nsmpl
    nvol = nvol_per_sweep(cfg, setup.natoms)
    targets = (cfg.acc_target_pos, cfg.acc_target_vol, cfg.acc_target_hmc)
    seed0 = (cfg.seed, cfg.seed + 7)
    setup = _refresh_cellmc_geom(setup)
    while True:
        # the chunk replaces and updates states and slabs; keep the
        # pre-chunk ensemble for the slab-overflow retry below
        pre_states = setup.states.clone()
        make = (SC.make_eam_run_fn if setup.style == "eam"
                else SC.make_cellmc_run_fn)
        run = make(
            setup.us.kb, setup.us.p2e, setup.geom, mod=cfg.mod,
            nrecords=nrecords, ncyc=SC.default_ncyc(setup.geom), nvol=nvol,
            factor=cfg.adapt_factor, vol_every=cfg.vol_every,
            rebin_every=cfg.rebin_every, targets=targets,
            exchange=exchange, npress=npress, ntemp=ntemp,
            write_traj=write_traj)
        if exchange:
            (states, slabs, slab_count, shift, slot_of, recs, frames, hist,
             xacc, diag, tried) = run(
                setup.states, setup.slabs, setup.slab_count, setup.shift,
                setup.slot_of, setup.gen, setup.pot, setup.cell_tabs,
                setup.t_grid, setup.p_grid, seed0)
        else:
            (states, slabs, slab_count, shift, recs, frames, diag,
             tried) = run(setup.states, setup.slabs, setup.slab_count,
                          setup.shift, setup.pot, setup.cell_tabs, seed0,
                          setup.gen)
            slot_of = setup.slot_of
            hist = slot_of[None].expand(nrecords, -1).clone()
            xacc = torch.zeros((nrecords,), dtype=torch.int64,
                               device=setup.device)
        diag_host = int(diag)         # the chunk's one sync
        if diag_host & SC.DIAG_SLAB_OVERFLOW:
            # a cell outgrew its slots: the chunk dropped atoms. Rebuild
            # from the PRE-chunk state with more slots and rerun.
            if setup.geom.kcap >= 96:
                raise RuntimeError(
                    f"cell slot overflow persists at kcap={setup.geom.kcap}:"
                    " the cell geometry no longer fits this density")
            warnings.warn(
                f"cell slot overflow at kcap={setup.geom.kcap}: retrying "
                f"chunk with kcap={setup.geom.kcap + 8}", RuntimeWarning,
                stacklevel=2)
            setup = dataclasses.replace(setup, states=pre_states)
            setup = _rebind_cellmc(setup, dataclasses.replace(
                setup.geom, kcap=setup.geom.kcap + 8))
            continue
        break
    if diag_host != 0:
        warnings.warn(
            f"sampling chunk finished with diagnostic flags {diag_host}: "
            "outputs may be physically wrong (cell width below rc)",
            RuntimeWarning, stacklevel=2)
    setup = dataclasses.replace(
        setup, states=states, slabs=slabs, slab_count=slab_count,
        shift=shift, slot_of=slot_of, moves_tried=setup.moves_tried + tried)
    return setup, recs, frames, hist, xacc, diag_host


def timed(device: torch.device):
    """Host seconds, taken after the device has finished its queue."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()
