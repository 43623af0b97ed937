"""Host-side run orchestration: config -> ensemble -> chunks -> files
(counterpart of ``neuralmelting_tpu.runner``, its single-process gather
cellmc and dense paths).

Builds the potential and the replica ensemble from a ``RunConfig`` on a
``device`` (the card unless the caller passes ``device="cpu"``) and
advances it in chunks with tempering. Three engines:

* ``gather`` (the default, as in the JAX package; LJ and EAM):
  checkerboard passes over per-replica neighbour lists
  (parallel/ensemble.py), every draw from the replicas' ``jax.random``
  keys, with volume trials and, with ``phmc > 0``, one HMC move a sweep;
  exchange is always on. LJ runs on stride-4 cells at rc; EAM samples
  its setfl splines (``models.eam.EAMTables`` on the run's device) on
  stride-2 cells at its interaction range 2 rc, with a density cache;
* ``cellmc`` (LJ and EAM): the ensemble binned into slabs, geometry
  maintenance (kcap hysteresis, cell-grid refresh) and the slab-overflow
  retry from a pre-chunk snapshot. LJ runs on stride-2 cells with
  kernels B1/B2; EAM ("eam/alloy", element "AL") samples the Chebyshev
  refit of its setfl table on stride-3 cells with one mover per cell and
  a density slab, kernels B3/B4;
* ``dense`` (LJ only, one process, as in the JAX package): checkerboard
  passes whose trial energies are taken against every atom and its
  periodic ghost images, with no neighbour list (sampler/dense.py,
  ops/ghosts.py, ops/dense_delta.py), on the gather engine's stride-4
  cells at rc, the ghost shell rc + skin; diag bit 4 is GHOST_OVERFLOW.
  EAM, ``phmc > 0`` and more than one process raise the JAX runner's
  exceptions before any work.

A chunk can log a ``sampling_chunk`` metrics event, write the
per-(P, T)-slot .thrm/.traj files (``write_slot_files``) and a checkpoint
(``io/checkpoint.py``) that ``restore_setup`` resumes exactly.

Multi-process runs (``parallel/mesh.init_multihost``, one process per
device): every rank builds the whole ensemble and keeps its shard of the
replicas. The gather engine builds its lists, cache and energies on the
shard and runs the same run function (parallel/ensemble.py), whose
rebuild decisions are ORed over the ranks and whose exchange runs on
gathered values, so it makes the decisions of one process, as the JAX
runner's GSPMD program does; the cellmc engine runs
``parallel/cellmc_sharded.py``. The chunk's records, slot history and
checkpoint are gathered on every rank and rank 0 alone writes them, in
the single-process layout. That checkpoint resumes in one process or in
several, and so does a single-process one: ``restore_setup`` loads it
whole on every rank and keeps the rank's shard. ``exchange=False`` is
refused there with a ValueError, as in the JAX runner.

Unlike the JAX runner there is no compile cache (nothing is traced) and
no scoped-VMEM guard (a TPU compiler limit).
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
import torch.distributed as dist

from neuralmelting_tpu_torch import units
from neuralmelting_tpu_torch.config import ELEMENTS, RunConfig, grids
from neuralmelting_tpu_torch.io import checkpoint as ckpt
from neuralmelting_tpu_torch.io import naming, thermo, traj
from neuralmelting_tpu_torch.models import eam as eam_mod
from neuralmelting_tpu_torch.models import eam_cheb, eam_gen
from neuralmelting_tpu_torch.models.lattice import make_supercell
from neuralmelting_tpu_torch.models.lj import LJCut
from neuralmelting_tpu_torch.ops import cellmc_eam as CE
from neuralmelting_tpu_torch.ops import cellmc_geom as CG
from neuralmelting_tpu_torch.ops import cells as cells_ops
from neuralmelting_tpu_torch.ops import ghosts as GH
from neuralmelting_tpu_torch.ops import jrandom
from neuralmelting_tpu_torch.ops import neighbors as NB
from neuralmelting_tpu_torch.ops import potential_ops as PO
from neuralmelting_tpu_torch.parallel import cellmc_sharded as CSH
from neuralmelting_tpu_torch.parallel import ensemble as ENS
from neuralmelting_tpu_torch.parallel import mesh
from neuralmelting_tpu_torch.sampler import cellmc as SC
from neuralmelting_tpu_torch.sampler import checkerboard as CB
from neuralmelting_tpu_torch.sampler import dense as DS
from neuralmelting_tpu_torch.sampler.state import ensemble_init

_LATER = {
    "serial": "the JAX runner has none either (ROADMAP A13); one serial "
              "chain runs through sampler/serial.py, see golden.py",
}
# the checkpoint extras that hold a row a replica: gathered whole before
# rank 0 writes them
_ROW_EXTRAS = ("slab_xyz", "slab_ids", "nl_ref_pos", "nl_ref_box")


def _multi() -> bool:
    return mesh.process_count() > 1


@dataclasses.dataclass
class RunSetup:
    cfg: RunConfig
    pot: object                # LJCut; EAM: EAMTables on gather, the
                               # sampled EAMCheb on cellmc
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
    engine: str = "gather"     # "gather" | "cellmc" | "dense"
    mass: float = 1.0
    # gather engine: per-replica neighbour lists, the potential cache,
    # the list capacity and the checkerboard (stride 4 LJ, 2 EAM)
    nls: object = None
    aux: object = None
    cap: int = 0
    cellcfg: object = None     # gather and dense engines
    table: object = None       # (ncolors, M) int64 colour table
    # dense engine: the ghost map, its shell (rc + skin) and capacity
    gms: object = None
    shell: float = 0.0
    gcap: int = 0
    geom: object = None
    slabs: object = None       # (x, y, z, ids[, rho]) leading-R
    slab_count: object = None  # (R, C) int32
    shift: object = None       # (3,) fractional grid shift
    cell_tabs: object = None   # (3, C*K) int32 row tables
    moves_tried: object = None  # () int64: attempted moves, all chunks
    # gather run functions by their parameters, shared by every setup
    # replaced from this one: each chunk of a run reuses the CUDA graphs
    # that its earlier chunks captured, and they go with the setup
    run_fns: dict = dataclasses.field(default_factory=dict)


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
              engine: str = "gather", device="cuda") -> RunSetup:
    """The ensemble of ``cfg`` on ``device`` with exact energies: on the
    gather engine (the default) with its neighbour lists and the JAX
    runner's checkerboard (stride 4 at rc for LJ, stride 2 at 2 rc for
    EAM, with the density cache), on the cellmc engine binned into
    slabs, on the dense engine with its ghost map (shell rc + skin,
    capacity ``ghosts.suggest_gcap``) and the energies of the JAX set-up,
    from neighbour lists. ``device`` is the card unless the caller asks
    for "cpu"; without a usable GPU the default raises."""
    if engine not in ("gather", "cellmc", "dense"):
        raise NotImplementedError(
            f"engine {engine!r} is not ported: {_LATER.get(engine, 'unknown engine')}")
    el = ELEMENTS[cfg.element]
    if cfg.phmc > 0 and engine == "cellmc":
        raise ValueError(
            f"HMC (phmc={cfg.phmc}) is not offered on the cellmc engine: "
            "use the gather engine, or drop phmc")
    if engine == "dense":
        _refuse_dense(cfg, el)
    dev = resolve_device(device)
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
    slot_of = torch.arange(r, dtype=torch.int32, device=dev)
    if engine == "dense":
        states = ensemble_init(pos, box, t_grid, p_grid, dpos0=cfg.dpos0,
                               dvol_frac0=cfg.dvol0, dt0=el.dt, device=dev,
                               seed=cfg.seed)
        shell = pot.rc_host + cfg.skin
        cellcfg = cells_ops.make_cell_config(box, pot.rc_host, stride=4,
                                             dpos_cap=0.25)
        return _install_ghosts(RunSetup(
            cfg=cfg, pot=pot, style=style, us=us, press=press, temp=temp,
            t_grid=t_grid, p_grid=p_grid, states=states, slot_of=slot_of,
            natoms=n, device=dev, engine="dense", mass=el.mass,
            cap=(cfg.max_neighbors if cfg.max_neighbors > 0
                 else NB.suggest_capacity(n, box, shell)),
            cellcfg=cellcfg, table=ENS.table_tensor(cellcfg, dev),
            shell=shell, gcap=GH.suggest_gcap(n, box, shell),
            moves_tried=torch.zeros((), dtype=torch.int64, device=dev)),
            states)
    if engine == "gather":
        states = ensemble_init(pos, box, t_grid, p_grid, dpos0=cfg.dpos0,
                               dvol_frac0=cfg.dvol0, dt0=el.dt, device=dev,
                               seed=cfg.seed)
        if _multi():
            # every rank built the same whole-R ensemble, each replica
            # with its global key: keep this rank's shard, and build the
            # lists, cache and energies on it (per replica, so the same
            # bits as building whole and slicing)
            states, slot_of = mesh.to_global((states, slot_of), r)
        if style == "eam":
            pot = eam_mod.to_device(pot, dev)
        cellcfg = cells_ops.make_cell_config(
            box, eam_mod.interaction_range(pot),
            stride=4 if style == "pair" else 2, dpos_cap=0.25)
        cap = cfg.max_neighbors if cfg.max_neighbors > 0 else None
        nls, cap = ENS.build_ensemble_nl(pot, states, skin=cfg.skin,
                                         capacity=cap, box_host=box)
        setup = RunSetup(
            cfg=cfg, pot=pot, style=style, us=us, press=press, temp=temp,
            t_grid=t_grid, p_grid=p_grid, states=states, slot_of=slot_of,
            natoms=n, device=dev, engine="gather", mass=el.mass,
            cap=cap, cellcfg=cellcfg,
            table=ENS.table_tensor(cellcfg, dev),
            moves_tried=torch.zeros((), dtype=torch.int64, device=dev))
        return _install_lists(setup, states, nls)
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
    if _multi():
        # every rank built the same whole-R ensemble: keep this rank's
        # shard of it
        states, slabs, slab_count, slot_of = mesh.to_global(
            (states, slabs, slab_count, slot_of), r)
    return RunSetup(
        cfg=cfg, pot=pot, style=style, us=us, press=press, temp=temp,
        t_grid=t_grid,
        p_grid=p_grid, states=states, slot_of=slot_of, natoms=n,
        device=dev, engine="cellmc", mass=el.mass, geom=geom,
        slabs=slabs,
        slab_count=slab_count, shift=shift,
        cell_tabs=torch.as_tensor(CG.geom_tables(geom), device=dev),
        moves_tried=torch.zeros((), dtype=torch.int64, device=dev))


def _refuse_dense(cfg: RunConfig, el):
    """The JAX runner's refusals of the dense engine, in its order, before
    any work (and, under several processes, before any collective: every
    rank raises)."""
    if cfg.phmc > 0:
        raise ValueError(
            f"HMC (phmc={cfg.phmc}) is not offered on the 'dense' engine — "
            "use --engine gather (or serial), or drop --phmc. Deliberate "
            "exclusion: README.md 'Known deviations'.")
    if el.potential.style != "lj/cut":
        raise ValueError("dense engine supports pair potentials only")
    if _multi():
        raise NotImplementedError(
            "multi-host runner supports the gather and cellmc engines; the "
            "dense/MXU engine is single-process (superseded by cellmc for "
            "production scale; ROADMAP A14)")


def _install_ghosts(setup: RunSetup, states) -> RunSetup:
    """The dense setup on these states: pe and the virial from neighbour
    lists, as the JAX set-up and restore take them (the lists are not
    kept), and the ghost map built from the positions."""
    nls, _ = ENS.build_ensemble_nl(setup.pot, states, skin=setup.cfg.skin,
                                   capacity=setup.cap)
    pe, vir = PO.ops_for_style("pair").total(setup.pot, states.pos,
                                             states.box, nls)
    del nls
    states = states.replace(pe=pe, virial=vir)
    return dataclasses.replace(
        setup, states=states,
        gms=DS.build_ensemble_ghosts(states, setup.shell, setup.gcap))


def _install_lists(setup: RunSetup, states, nls) -> RunSetup:
    """The gather setup on these states and lists, with the potential
    cache and exact pe/virial from the lists."""
    aux = ENS.build_ensemble_aux(setup.pot, states, nls)
    pe, vir = PO.ops_for_style(setup.style).total(setup.pot, states.pos,
                                                  states.box, nls)
    return dataclasses.replace(setup, states=states.replace(pe=pe,
                                                            virial=vir),
                               nls=nls, aux=aux)


def _bin_tightened(geom, states, shift):
    """Bin the ensemble, tighten kcap to the measured occupancy (sweep cost
    is linear in K), and re-bin if it tightened."""
    slabs, slab_count, over = SC.build_slabs(geom, states, shift)
    kt = CG.tight_kcap(int(torch.max(slab_count)), geom.nsub)
    if kt < geom.kcap:
        geom = dataclasses.replace(geom, kcap=kt)
        slabs, slab_count, over = SC.build_slabs(geom, states, shift)
    return geom, slabs, slab_count, over


def _install_slabs(setup: RunSetup, geom, slabs, slab_count,
                   shift) -> RunSetup:
    """The setup on these slabs of ``geom``, with exact pe/virial from
    them (and, for EAM, the density slab)."""
    if setup.style == "eam":
        states, slabs = _eam_rho(geom, setup.states, slabs, setup.pot,
                                 setup.device)
    else:
        states = SC.refresh_energies(geom, setup.states, slabs, setup.pot)
    return dataclasses.replace(
        setup, geom=geom, slabs=slabs, slab_count=slab_count, shift=shift,
        cell_tabs=torch.as_tensor(CG.geom_tables(geom), device=setup.device),
        states=states)


def _rebind_cellmc(setup: RunSetup, geom) -> RunSetup:
    """Re-bin the CURRENT ensemble (positions exact at a chunk boundary)
    into slabs for a new geometry; grows kcap once more if the new cap
    still overflows. Under more than one process: gathers the ensemble,
    re-bins it whole on every rank and keeps this rank's shard again."""
    if not _multi():
        return _rebind_whole(setup, geom)
    r = setup.t_grid.shape[0]
    whole = _rebind_whole(dataclasses.replace(
        setup, states=mesh.host_fetch(setup.states, r)), geom)
    states, slabs, count = mesh.to_global(
        (whole.states, whole.slabs, whole.slab_count), r)
    return dataclasses.replace(whole, states=states, slabs=slabs,
                               slab_count=count)


def _rebind_whole(setup: RunSetup, geom) -> RunSetup:
    shift = torch.zeros((3,), dtype=torch.float32, device=setup.device)
    slabs, slab_count, over = SC.build_slabs(geom, setup.states, shift)
    if bool(over):
        geom = dataclasses.replace(
            geom, kcap=CG.tight_kcap(int(torch.max(slab_count)), geom.nsub))
        slabs, slab_count, over = SC.build_slabs(geom, setup.states, shift)
        if bool(over):
            raise RuntimeError("cell slot overflow persists after rebuild")
    return _install_slabs(setup, geom, slabs, slab_count, shift)


def checkpoint_extras(setup: RunSetup) -> dict:
    """What an exact resume needs beyond the states (their keys included)
    and ``slot_of``. Gather: the positions and boxes the neighbour lists
    were built from and their capacity, so the restored lists are the
    same lists. Cellmc: the slabs as the chunk left them (geometry, grid
    shift, coordinates in the shifted frame and the atom of every slot);
    its host draws need nothing, since their key chain is rederived from
    the config's seed and the sweep counter. EAM's density (the
    gather cache, the cellmc slab) is recomputed at restore, as exactly
    as the last record computed it. Dense: every array of the ghost map,
    whose unwrapped rows and rescaled shell the states do not give (the
    states' pe and virial are the last record's dense totals)."""
    if setup.engine == "dense":
        return {"gh_" + f: getattr(setup.gms, f) for f in GH.FIELDS}
    if setup.engine == "gather":
        return {"nl_ref_pos": setup.nls.ref_pos,
                "nl_ref_box": setup.nls.ref_box,
                "nl_capacity": np.int32(setup.cap)}
    g = setup.geom
    return {"geom": np.asarray(list(g.ncell) + [g.kcap], np.int32),
            "shift": setup.shift,
            "slab_xyz": torch.stack(tuple(setup.slabs[:3]), dim=1),
            "slab_ids": setup.slabs[3]}


def restore_setup(setup: RunSetup, checkpoint_path: str) -> RunSetup:
    """Resume from a checkpoint: replaces the states (their keys
    included) and ``slot_of`` and rebuilds every position-derived
    structure from the restored ensemble, never from the lattice of
    ``setup``. Gather: the neighbour lists, the potential cache and the
    energies; a port checkpoint brings the positions and boxes its lists
    were built from, so they are the same lists and the run goes on as if
    it had not stopped; a JAX package checkpoint has none, and its lists
    are built from its positions, as the JAX runner builds them. Cellmc:
    a port checkpoint brings its slabs and grid shift; a JAX package
    checkpoint has neither: its positions are re-binned at shift 0
    through ``_rebind_cellmc`` (whose kcap grow-and-retry absorbs a
    compressed box), with a warning. Either way the host draws go on
    from the key chain of ``cfg.seed`` at the states' sweep counter, on
    any device. Dense: a port checkpoint brings its ghost map, which
    goes on as it was, and the states keep their record energies; a JAX
    package checkpoint has none: its ghosts are built from its positions
    and its energies taken from neighbour lists, as the JAX runner
    restores, with a warning. Warns when the stored config differs from
    the current one.

    Under more than one process: a barrier first, so that no rank reads
    a checkpoint rank 0 is still writing; then every rank loads the same
    whole-R checkpoint, keeps its shard of the states, ``slot_of`` and
    the slabs (cellmc) or the lists' reference positions and boxes
    (gather), and rebuilds the lists, cache and energies (gather) or the
    energies and the EAM density slab (cellmc) on that shard, as the JAX
    runner restores whole and shards again. A checkpoint whose ensemble
    is not this run's raises the same ValueError on every rank."""
    mesh.barrier()
    states, slot_of, cfg_json, extra = ckpt.load(checkpoint_path,
                                                 setup.device)
    if cfg_json not in ("{}", setup.cfg.to_json()):
        warnings.warn("checkpoint was written with a different RunConfig; "
                      "proceeding with the current flags", stacklevel=2)
    r = len(setup.press) * len(setup.temp)
    if tuple(states.pos.shape) != (r, setup.natoms, 3):
        raise ValueError(
            f"checkpoint ensemble {tuple(states.pos.shape)} does not fit "
            f"this run's {(r, setup.natoms, 3)} (replicas, atoms)")
    if setup.engine == "gather":
        return _restore_gather(setup, states, slot_of, extra)
    if setup.engine == "dense":
        return _restore_dense(setup, states, slot_of, extra,
                              checkpoint_path)
    dev = setup.device
    xyz = ids = None
    if "slab_ids" in extra:
        xyz = torch.as_tensor(extra["slab_xyz"], dtype=torch.float32,
                              device=dev)
        ids = torch.as_tensor(extra["slab_ids"], dtype=torch.int32,
                              device=dev)
    if _multi():
        # every rank loaded the same whole-R checkpoint: keep this
        # rank's shard of it
        states, slot_of, xyz, ids = mesh.to_global(
            (states, slot_of, xyz, ids), r)
    setup = dataclasses.replace(setup, states=states, slot_of=slot_of)
    if ids is None:
        warnings.warn(f"checkpoint {checkpoint_path} holds no slabs: its "
                      "positions are re-binned at grid shift 0",
                      RuntimeWarning, stacklevel=2)
        return _rebind_cellmc(setup, setup.geom)
    nx, ny, nz, kcap = (int(v) for v in extra["geom"])
    geom = dataclasses.replace(setup.geom, ncell=(nx, ny, nz), kcap=kcap)
    count = (ids >= 0).reshape(ids.shape[0], geom.ncells, kcap).sum(
        dim=2, dtype=torch.int32)
    shift = torch.as_tensor(extra["shift"], dtype=torch.float32, device=dev)
    slabs = tuple(xyz[:, a].contiguous() for a in range(3)) + (ids,)
    return _install_slabs(setup, geom, slabs, count, shift)


def _restore_dense(setup: RunSetup, states, slot_of, extra,
                   checkpoint_path: str) -> RunSetup:
    setup = dataclasses.replace(setup, slot_of=slot_of)
    if "gh_pos_ext" not in extra:
        warnings.warn(f"checkpoint {checkpoint_path} holds no ghost map: "
                      "its ghosts are built from its positions and its "
                      "energies taken from neighbour lists, as the JAX "
                      "runner restores", RuntimeWarning, stacklevel=3)
        return _install_ghosts(setup, states)
    gms = GH.GhostMap(**{f: torch.as_tensor(extra["gh_" + f],
                                            device=setup.device)
                         for f in GH.FIELDS})
    if gms.gcap != setup.gcap:
        raise ValueError(f"checkpoint ghost capacity {gms.gcap}, this "
                         f"run's {setup.gcap}")
    return dataclasses.replace(setup, states=states, gms=gms)


def _restore_gather(setup: RunSetup, states, slot_of, extra) -> RunSetup:
    dev = setup.device
    ref_pos = ref_box = None
    if "nl_ref_pos" in extra:
        if int(extra["nl_capacity"]) != setup.cap:
            raise ValueError(
                f"checkpoint lists hold {int(extra['nl_capacity'])} "
                f"neighbours a row, this run's {setup.cap}")
        ref_pos = torch.as_tensor(extra["nl_ref_pos"], device=dev)
        ref_box = torch.as_tensor(extra["nl_ref_box"], device=dev)
    if _multi():
        # every rank loaded the same whole-R checkpoint: keep this
        # rank's shard of it
        states, slot_of, ref_pos, ref_box = mesh.to_global(
            (states, slot_of, ref_pos, ref_box), setup.t_grid.shape[0])
    ref = states if ref_pos is None else states.replace(pos=ref_pos,
                                                        box=ref_box)
    nls, _ = ENS.build_ensemble_nl(setup.pot, ref, skin=setup.cfg.skin,
                                   capacity=setup.cap)
    setup = dataclasses.replace(setup, slot_of=slot_of)
    return _install_lists(setup, states, nls)


def _refresh_cellmc_geom(setup: RunSetup) -> RunSetup:
    """Pre-chunk geometry maintenance: re-derive the cell grid from the
    current boxes (cells must keep covering rc) and re-tighten kcap, with
    hysteresis: grow when occupancy is within 4 slots of the cap, shrink
    when the tight cap is 16 below it."""
    g = setup.geom
    # over every rank's replicas
    minbox = mesh.all_reduce_(torch.min(setup.states.box, dim=0).values,
                              dist.ReduceOp.MIN).cpu().numpy()
    ng = CG.make_geom(minbox.astype(np.float64), setup.pot.rc_host,
                      setup.natoms, nsub=g.nsub, stride=g.stride)
    if ng.ncell != g.ncell:
        return _rebind_cellmc(setup, ng)
    maxcount = int(mesh.all_reduce_(torch.max(setup.slab_count),
                                    dist.ReduceOp.MAX))
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


def run_sampling(setup: RunSetup, outdir: Optional[str] = None,
                 write_files: bool = True,
                 checkpoint_path: Optional[str] = None,
                 nrecords: Optional[int] = None, write_traj: bool = True,
                 metrics=None, exchange: bool = True):
    """Advance the ensemble ``nrecords`` record blocks (one chunk).

    Returns (setup, recs, frames, hist, xacc, diag): recs fields (nrec, R)
    replica-ordered, frames (positions (nrec, R, N, 3), boxes (nrec, R, 3))
    or None, hist (nrec, R) the replica -> slot map at each record, xacc
    (nrec,) accepted swaps, diag the chunk's diagnostic bits (int).
    ``exchange=False`` keeps every replica on its slot; as in the JAX
    runner it is offered on the single-process cellmc engine only, and
    elsewhere raises ValueError. Then, as in the JAX runner: a ``sampling_chunk``
    event to ``metrics`` (a ``utils.MetricsLogger``), the slot files into
    ``outdir`` when ``write_files``, and a checkpoint to
    ``checkpoint_path``. Under more than one process the returned recs,
    frames and hist are whole-R on every rank (``setup`` keeps the
    rank's shard), and rank 0 alone writes.
    """
    t0 = time.time()
    cfg = setup.cfg
    npress, ntemp = len(setup.press), len(setup.temp)
    nrecords = nrecords or cfg.nsmpl
    multi = _multi()
    if not exchange and (setup.engine != "cellmc" or multi):
        # as the JAX runner, on every rank before any collective
        raise ValueError(
            "exchange=False is offered on the single-process cellmc "
            "engine only (coexistence experiments run there); got "
            f"engine={setup.engine!r}, processes={mesh.process_count()}")
    if setup.engine == "gather":
        setup, recs, frames, hist, xacc, diag_host = _run_gather(
            setup, nrecords, write_traj)
    elif setup.engine == "dense":
        setup, recs, frames, hist, xacc, diag_host = _run_dense(
            setup, nrecords, write_traj)
    else:
        setup, recs, frames, hist, xacc, diag_host = _run_cellmc(
            setup, nrecords, write_traj, exchange)
    is_writer = True
    ck_states, ck_slots = setup.states, setup.slot_of
    if multi:
        # collectives: every rank gathers, rank 0 writes
        r = setup.t_grid.shape[0]
        recs, frames, hist = mesh.host_fetch((recs, frames, hist), r,
                                             axis=1)
        if checkpoint_path:
            ck_states, ck_slots = mesh.host_fetch(
                (setup.states, setup.slot_of), r)
        is_writer = mesh.process_index() == 0
    if metrics is not None and is_writer:
        metrics.log("sampling_chunk", records=int(nrecords),
                    replicas=int(hist.shape[1]), natoms=setup.natoms,
                    seconds=round(time.time() - t0, 3), diag=diag_host,
                    exchange_acc=[int(x) for x in xacc.tolist()])
    if write_files and outdir is not None and is_writer:
        os.makedirs(outdir, exist_ok=True)
        write_slot_files(cfg, outdir, recs, frames, hist, npress, ntemp,
                         setup.natoms)
    if checkpoint_path:
        extras = checkpoint_extras(setup)
        if multi:
            for k in _ROW_EXTRAS:
                if k in extras:
                    extras[k] = mesh.all_gather(extras[k])
        if is_writer:
            ckpt.save(checkpoint_path, ck_states, ck_slots, cfg.to_json(),
                      extras)
    return setup, recs, frames, hist, xacc, diag_host


_GATHER_DIAG = {1: "NL_OVERFLOW", 2: "CB_INVALID", 8: "NL_STALE"}
_DENSE_DIAG = {CB.DIAG_CB_INVALID: "CB_INVALID",
               DS.DIAG_GHOST_OVERFLOW: "GHOST_OVERFLOW"}
def _warn_diag(diag_host: int, names: dict, advice: str = ""):
    """A chunk's warning for nonzero diag bits, named from ``names``."""
    if diag_host:
        bits = "|".join(v for k, v in names.items() if diag_host & k)
        warnings.warn(
            f"sampling chunk finished with diagnostic flags {diag_host} "
            f"({bits}): outputs may be physically wrong{advice}",
            RuntimeWarning, stacklevel=4)


_CELLMC_DIAG = {SC.DIAG_CB_INVALID: "CB_INVALID",
                SC.DIAG_SLAB_OVERFLOW: "SLAB_OVERFLOW",
                SC.DIAG_SHIFT_DESYNC: "SHIFT_DESYNC"}


def gather_run_kwargs(setup: RunSetup, nrecords: int,
                      write_traj: bool) -> dict:
    """The keyword arguments of ``parallel.ensemble.make_ensemble_run_fn``
    (after kb, p2e and the cell config) for a chunk of ``setup``."""
    cfg = setup.cfg
    return dict(
        skin=cfg.skin, capacity=setup.cap, mod=cfg.mod, nrecords=nrecords,
        nvol=nvol_per_sweep(cfg, setup.natoms),
        nhmc=1 if cfg.phmc > 0 else 0, nstps=cfg.nstps, mass=setup.mass,
        factor=cfg.adapt_factor,
        targets=(cfg.acc_target_pos, cfg.acc_target_vol,
                 cfg.acc_target_hmc),
        natoms=setup.natoms, exchange=True, npress=len(setup.press),
        ntemp=len(setup.temp), style=setup.style, write_traj=write_traj)


def _gather_run_fn(setup: RunSetup, nrecords: int, write_traj: bool):
    kw = gather_run_kwargs(setup, nrecords, write_traj)
    key = (setup.pot, setup.us.kb, setup.us.p2e, setup.cellcfg.ncell,
           setup.cellcfg.stride) + tuple(kw.items())
    if key not in setup.run_fns:
        setup.run_fns[key] = ENS.make_ensemble_run_fn(
            setup.us.kb, setup.us.p2e, setup.cellcfg, **kw)
    return setup.run_fns[key]


def _run_gather(setup: RunSetup, nrecords: int, write_traj: bool):
    """One gather chunk with exchange (``runner.py:632-650`` of the JAX
    package): the run function of ``parallel/ensemble.py`` with the
    exchange key ``key(cfg.seed + 1)``."""
    cfg = setup.cfg
    run = _gather_run_fn(setup, nrecords, write_traj)
    (states, nls, aux, slot_of, recs, frames, hist, xacc, diag,
     tried) = run(setup.states, setup.nls, setup.aux, setup.slot_of,
                  jrandom.key(cfg.seed + 1).to(setup.device), setup.pot,
                  setup.table, setup.t_grid, setup.p_grid)
    diag_host = int(diag)
    _warn_diag(diag_host, _GATHER_DIAG,
               " — increase max_neighbors/skin or reduce step caps")
    setup = dataclasses.replace(setup, states=states, nls=nls, aux=aux,
                                slot_of=slot_of,
                                moves_tried=setup.moves_tried + tried)
    return setup, recs, frames, hist, xacc, diag_host


def dense_run_kwargs(setup: RunSetup, nrecords: int,
                     write_traj: bool) -> dict:
    """The keyword arguments of ``sampler.dense.make_dense_run_fn`` (after
    kb, p2e and the cell config) for a chunk of ``setup``."""
    cfg = setup.cfg
    return dict(
        shell=setup.shell, gcap=setup.gcap, mod=cfg.mod, nrecords=nrecords,
        npasses=CB.default_npasses(setup.natoms, setup.cellcfg),
        nvol=nvol_per_sweep(cfg, setup.natoms), factor=cfg.adapt_factor,
        targets=(cfg.acc_target_pos, cfg.acc_target_vol,
                 cfg.acc_target_hmc),
        exchange=True, npress=len(setup.press), ntemp=len(setup.temp),
        write_traj=write_traj)


def _run_dense(setup: RunSetup, nrecords: int, write_traj: bool):
    """One dense chunk with exchange (``runner.py:611-631`` of the JAX
    package): the run function of ``sampler/dense.py``, kept with the
    setup like gather's, with the exchange key ``key(cfg.seed + 1)``."""
    cfg = setup.cfg
    kw = dense_run_kwargs(setup, nrecords, write_traj)
    key = ("dense", setup.pot, setup.us.kb, setup.us.p2e,
           setup.cellcfg.ncell) + tuple(kw.items())
    if key not in setup.run_fns:
        setup.run_fns[key] = DS.make_dense_run_fn(
            setup.us.kb, setup.us.p2e, setup.cellcfg, **kw)
    (states, gms, slot_of, recs, frames, hist, xacc, diag,
     tried) = setup.run_fns[key](
        setup.states, setup.gms, setup.slot_of,
        jrandom.key(cfg.seed + 1).to(setup.device), setup.pot, setup.table,
        setup.t_grid, setup.p_grid)
    diag_host = int(diag)
    _warn_diag(diag_host, _DENSE_DIAG,
               " — increase the skin or reduce step caps")
    setup = dataclasses.replace(setup, states=states, gms=gms,
                                slot_of=slot_of,
                                moves_tried=setup.moves_tried + tried)
    return setup, recs, frames, hist, xacc, diag_host


def _run_cellmc(setup: RunSetup, nrecords: int, write_traj: bool,
                exchange: bool):
    """One cellmc chunk, with the slab-overflow retry."""
    cfg = setup.cfg
    npress, ntemp = len(setup.press), len(setup.temp)
    nvol = nvol_per_sweep(cfg, setup.natoms)
    targets = (cfg.acc_target_pos, cfg.acc_target_vol, cfg.acc_target_hmc)
    seed0 = (cfg.seed, cfg.seed + 7)
    setup = _refresh_cellmc_geom(setup)
    while True:
        # the chunk replaces and updates states and slabs; keep the
        # pre-chunk ensemble for the slab-overflow retry below
        pre_states = setup.states.clone()
        kw = dict(mod=cfg.mod, nrecords=nrecords,
                  ncyc=SC.default_ncyc(setup.geom), nvol=nvol,
                  factor=cfg.adapt_factor, vol_every=cfg.vol_every,
                  rebin_every=cfg.rebin_every, targets=targets,
                  npress=npress, ntemp=ntemp, write_traj=write_traj)
        if _multi():
            run = CSH.make_sharded_cellmc_run_fn(
                setup.us.kb, setup.us.p2e, setup.geom, style=setup.style,
                **kw)
        else:
            make = (SC.make_eam_run_fn if setup.style == "eam"
                    else SC.make_cellmc_run_fn)
            run = make(setup.us.kb, setup.us.p2e, setup.geom,
                       exchange=exchange, **kw)
        if exchange:
            (states, slabs, slab_count, shift, slot_of, recs, frames, hist,
             xacc, diag, tried) = run(
                setup.states, setup.slabs, setup.slab_count, setup.shift,
                setup.slot_of, jrandom.key(cfg.seed + 1), setup.pot,
                setup.cell_tabs, setup.t_grid, setup.p_grid, seed0)
        else:
            (states, slabs, slab_count, shift, recs, frames, diag,
             tried) = run(setup.states, setup.slabs, setup.slab_count,
                          setup.shift, setup.pot, setup.cell_tabs, seed0)
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
                stacklevel=3)
            setup = dataclasses.replace(setup, states=pre_states)
            setup = _rebind_cellmc(setup, dataclasses.replace(
                setup.geom, kcap=setup.geom.kcap + 8))
            continue
        break
    _warn_diag(diag_host, _CELLMC_DIAG)
    setup = dataclasses.replace(
        setup, states=states, slabs=slabs, slab_count=slab_count,
        shift=shift, slot_of=slot_of, moves_tried=setup.moves_tried + tried)
    return setup, recs, frames, hist, xacc, diag_host


def write_slot_files(cfg: RunConfig, outdir: str, recs, frames, hist,
                     npress: int, ntemp: int, natoms: int):
    """Distribute replica-ordered records into per-(P, T)-slot text files:
    one argsort of ``hist`` for every record, one host copy of each
    record field and of the frames for the whole chunk."""
    el = ELEMENTS[cfg.element]
    hist = hist.cpu().numpy()                    # (nrec, R) replica->slot
    nrec, r = hist.shape
    rec_np = {c: getattr(recs, c).cpu().numpy() for c in thermo.COLUMNS}
    if frames is not None:
        pos_np = frames[0].cpu().numpy()         # (nrec, R, N, 3)
        box_np = frames[1].cpu().numpy()         # (nrec, R, 3)
    # sel_all[k, slot] = the replica holding ``slot`` at record k
    sel_all = np.argsort(hist, axis=1)
    recs_idx = np.arange(nrec)
    rows_all = {c: rec_np[c][recs_idx[:, None], sel_all]
                for c in thermo.COLUMNS}         # (nrec, R) slot-ordered
    for slot in range(r):
        p_idx, t_idx = divmod(slot, ntemp)
        prefix = naming.sample_prefix(cfg.name, cfg.element, el.lattice,
                                      cfg.ncells, p_idx, t_idx)
        tpath, jpath = naming.sample_paths(outdir, prefix)
        sel = sel_all[:, slot]
        rows = {c: rows_all[c][:, slot] for c in thermo.COLUMNS}
        params = {"element": cfg.element, "natoms": natoms,
                  "press_idx": p_idx, "temp_idx": t_idx,
                  "config": cfg.to_json()}
        thermo.write(tpath, rows, params=params)
        if frames is not None and cfg.write_traj:
            traj.write(jpath, pos_np[recs_idx, sel], box_np[recs_idx, sel],
                       sweeps=rows["sweep"].astype(np.int64))


def timed(device: torch.device):
    """Host seconds, taken after the device has finished its queue."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()
