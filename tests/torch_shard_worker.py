"""One port rank of the two-process tests (test_torch_sharded_*.py,
test_torch_multiproc.py); this module holds no tests and imports nothing
of JAX or of the JAX package.

    python tests/torch_shard_worker.py <port> <rank> <nprocs> <mode> <in.npz> <out.npz>

mode "chunk": join the gloo group on 127.0.0.1:<port>, take this rank's
shard of the whole-R inputs in <in.npz> (written by
tests/torch_chunk_case.py ``save_inputs``), run one chunk of
parallel/cellmc_sharded.py and let rank 0 write the gathered outputs.
mode "c13": the gather set-up under two processes (each rank holds R / 2
rows), the refusal of ``exchange=False`` (the JAX runner refuses it too)
and a chunk in which the two ranks raise different diag bits; rank 0
writes what it saw.
mode "restart": ``runner.restore_setup`` under two processes, <in.npz>
standing for the directory that holds the rc 3.8 Al table and the
single-process checkpoints of ``RESTART_CFGS["lj"]`` (``one.npz``, and
``noslab.npz`` without the port's extras). For LJ and EAM, two chunks,
the first checkpointed, then the second again from that checkpoint on
fresh set-ups; the 1-process checkpoint restored and one chunk run on
it; the one without slabs likewise; a run of another R refused. Rank 0
writes every gathered outcome (``restart_outcome``).
mode "gather": the gather engine, <in.npz> standing for the directory
that holds the rc 3.8 Al table and the single-process checkpoints of
``GATHER_CFGS["lj"]`` (``one.npz``, and ``noref.npz`` without the lists'
extras). For LJ (with HMC) and EAM, two chunks, LJ's first checkpointed
into ``two.npz``; then LJ's second chunk again from ``two.npz``, from
``one.npz`` and from ``noref.npz`` on fresh set-ups; then one chunk in
which rank 0 alone raises CB_INVALID. Rank 0 writes every gathered
outcome (``gather_outcome``), each rank's ``COUNTS`` included.
"""

import dataclasses
import os
import sys
import warnings

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from neuralmelting_tpu_torch import runner  # noqa: E402
from neuralmelting_tpu_torch.config import RunConfig  # noqa: E402
from neuralmelting_tpu_torch.models.eam_cheb import cheb_from_numpy  # noqa: E402,E501
from neuralmelting_tpu_torch.models.lj import LJCut  # noqa: E402
from neuralmelting_tpu_torch.ops import cellmc_geom as CG  # noqa: E402
from neuralmelting_tpu_torch.ops import jrandom  # noqa: E402
from neuralmelting_tpu_torch.parallel import cellmc_sharded as CSH  # noqa: E402,E501
from neuralmelting_tpu_torch.parallel import ensemble as ENS  # noqa: E402
from neuralmelting_tpu_torch.parallel import mesh  # noqa: E402
from neuralmelting_tpu_torch.sampler import cellmc as SC  # noqa: E402
from neuralmelting_tpu_torch.sampler import checkerboard as CB  # noqa: E402,E501
from neuralmelting_tpu_torch.sampler.state import (FIELDS,  # noqa: E402
                                                   state_from_numpy)

RESTART_CFGS = {
    "lj": RunConfig(name="rs", element="LJ", ncells=(4, 4, 4), npress=2,
                    press=(1.0, 4.0), ntemp=2, temp=(0.6, 1.4), nsmpl=2,
                    mod=3, seed=5, vol_every=1, rebin_every=1),
    "eam": RunConfig(name="rs", element="AL", ncells=(4, 4, 4), npress=2,
                     press=(1.0, 5000.0), ntemp=2, temp=(600.0, 1400.0),
                     nsmpl=2, mod=2, seed=4, dpos0=0.15, dvol0=0.002,
                     vol_every=1, rebin_every=1),
}
# the gather engine's cases: LJ with HMC on a 1 x 4 grid (rank 0 holds
# the two cold replicas, rank 1 the two hot ones, whose HMC budget asks
# for rebuilds that rank 0's would not) and EAM on a 2 x 2 grid
GATHER_CFGS = {
    "lj": RunConfig(name="gs", element="LJ", ncells=(4, 4, 4), npress=1,
                    press=(1.0,), ntemp=4, temp=(0.3, 0.35, 1.5, 1.6),
                    nsmpl=2, mod=2, seed=6, dpos0=0.05, phmc=0.05,
                    nstps=4),
    "eam": RunConfig(name="gs", element="AL", ncells=(4, 4, 4), npress=2,
                     press=(1.0, 5000.0), ntemp=2, temp=(600.0, 650.0),
                     nsmpl=2, mod=1, seed=4, dpos0=0.15, dvol0=0.002),
}
COUNTED = ("rebuilds", "syncs", "remote_rebuilds")
TABLE = "al38.eam.alloy"
CHEB = ("rc", "u_lo", "u_hi", "rho_hi", "q_lo", "c_phi", "c_phid", "c_rho",
        "c_rhod", "c_f", "c_fd")


def load_inputs(path):
    """The whole-R inputs of one chunk and the runner's parameters."""
    z = dict(np.load(path))
    states, _ = state_from_numpy({f: z["s_" + f] for f in FIELDS})
    nsl = int(z["nslabs"])
    slabs = tuple(torch.as_tensor(z[f"sl_{i}"]) for i in range(nsl))
    nx, ny, nz, kcap, nsub, stride, natoms = (int(v) for v in z["geom"])
    geom = CG.CellGeom(ncell=(nx, ny, nz), kcap=kcap, nsub=nsub,
                       natoms=natoms, stride=stride)
    style = str(z["style"])
    if style == "eam":
        pot = cheb_from_numpy({k: z["p_" + k] for k in CHEB})
    else:
        pot = LJCut.create(*(float(v) for v in z["lj"]))
    return dict(z=z, states=states, slabs=slabs, geom=geom, style=style,
                pot=pot, count=torch.as_tensor(z["count"]),
                shift=torch.as_tensor(z["shift"]),
                slot_of=torch.as_tensor(z["slot_of"]),
                t_grid=torch.as_tensor(z["t_grid"]),
                p_grid=torch.as_tensor(z["p_grid"]),
                cell_tabs=torch.as_tensor(z["cell_tabs"]))


def run_chunk(c):
    z = c["z"]
    r = c["t_grid"].shape[0]
    kw = {k: int(z["run"][i]) for i, k in enumerate(
        ("mod", "nrecords", "npress", "ntemp", "ncyc", "nvol", "vol_every",
         "rebin_every", "adapt"))}
    kw["adapt"] = bool(kw["adapt"])
    run = CSH.make_sharded_cellmc_run_fn(float(z["kb"]), float(z["p2e"]),
                                         c["geom"], style=c["style"], **kw)
    states, slabs, count, slot_of = mesh.to_global(
        (c["states"], c["slabs"], c["count"], c["slot_of"]), r)
    return run(states, slabs, count, c["shift"], slot_of,
               jrandom.key(int(z["xkey"])), c["pot"], c["cell_tabs"],
               c["t_grid"], c["p_grid"],
               tuple(int(v) for v in z["seed0"])), r


def chunk(inp, out):
    c = load_inputs(inp)
    (states, slabs, count, shift, slot_of, recs, frames, hist, xacc, diag,
     tried), r = run_chunk(c)
    states, slot_of = mesh.host_fetch((states, slot_of), r)
    recs, hist = mesh.host_fetch((recs, hist), r, axis=1)
    if mesh.process_index() == 0:
        arrays = {"s_" + f: getattr(states, f).numpy() for f in FIELDS}
        arrays.update({"r_" + k: v.numpy() for k, v in vars(recs).items()})
        np.savez(out, shift=shift.numpy(), slot_of=slot_of.numpy(),
                 hist=hist.numpy(), xacc=xacc.numpy(), diag=int(diag),
                 **arrays)


def c13(inp, out):
    rank = mesh.process_index()
    seen = []
    cfg = RunConfig(name="c13", element="LJ", ncells=(4, 4, 4), npress=1,
                    ntemp=2, press=(1.0,), temp=(0.7, 1.3), nsmpl=1, mod=1,
                    seed=3)
    # the gather set-up holds this rank's rows
    g = runner.setup_run(cfg, device="cpu")
    seen.append(f"gather:{g.states.pos.shape[0]} of {g.t_grid.shape[0]} "
                "rows")
    # the refusal must say the JAX runner's words
    try:
        runner.run_sampling(runner.setup_run(cfg, engine="cellmc",
                                             device="cpu"), exchange=False)
    except ValueError as e:
        if "single-process cellmc engine only" in str(e):
            seen.append("no_exchange:ValueError")
    # the two ranks raise different bits: CB_INVALID on rank 0,
    # SLAB_OVERFLOW on rank 1
    bit = (SC.DIAG_CB_INVALID, SC.DIAG_SLAB_OVERFLOW)[rank]
    SC._cells_cover = lambda states, geom, rc2: torch.tensor(bit)
    c = load_inputs(inp)
    out_ = run_chunk(c)[0]
    if rank == 0:
        np.savez(out, refused=np.asarray(seen), diag=int(out_[9]))


def restart_outcome(setup, outs, tag):
    """The gathered outcome of a chunk (``run_sampling``'s returns after
    the setup) and of the setup it left, as numpy arrays keyed
    ``<tag>_<name>``: records ``r_*``, frames, hist, xacc, diag, states
    ``s_*``, slot_of, shift and the slabs (a collective on every rank)."""
    r = setup.t_grid.shape[0]
    states, slot_of = mesh.host_fetch((setup.states, setup.slot_of), r)
    xyz = mesh.all_gather(torch.stack(tuple(setup.slabs[:3]), dim=1))
    ids = mesh.all_gather(setup.slabs[3])
    got = {"s_" + f: getattr(states, f) for f in FIELDS}
    got.update(slot_of=slot_of, shift=setup.shift, slab_xyz=xyz,
               slab_ids=ids)
    if outs is not None:
        recs, frames, hist, xacc, diag = outs
        got.update({"r_" + k: v for k, v in vars(recs).items()})
        got.update(frame_pos=frames[0], frame_box=frames[1], hist=hist,
                   xacc=xacc, diag=torch.tensor(diag))
    return {f"{tag}_{k}": v.numpy() for k, v in got.items()}


def restart(d, out):
    res = {}
    table = os.path.join(d, TABLE)

    def fresh(cfg):
        return runner.setup_run(cfg, setfl=table, engine="cellmc",
                                device="cpu")

    # 2 -> 2: the second chunk uninterrupted (a), then again from the
    # first chunk's checkpoint on a fresh set-up (b)
    for style, cfg in RESTART_CFGS.items():
        ck = os.path.join(d, f"{style}.two.npz")
        a = runner.run_sampling(fresh(cfg), write_files=False,
                                checkpoint_path=ck)[0]
        a, *outs = runner.run_sampling(a, write_files=False)
        res.update(restart_outcome(a, outs, f"{style}_a"))
        with warnings.catch_warnings():
            warnings.simplefilter("error")      # no re-binning, no warning
            b = runner.restore_setup(fresh(cfg), ck)
        b, *outs = runner.run_sampling(b, write_files=False)
        res.update(restart_outcome(b, outs, f"{style}_b"))
    # 1 -> 2: the restored shards, then one chunk on them
    lj = RESTART_CFGS["lj"]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        s = runner.restore_setup(fresh(lj), os.path.join(d, "one.npz"))
    res.update(restart_outcome(s, None, "one_restored"))
    s, *outs = runner.run_sampling(s, write_files=False, nrecords=1)
    res.update(restart_outcome(s, outs, "one_resumed"))
    # the JAX layout, no slabs: a warning, a re-bin at shift 0
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        s = runner.restore_setup(fresh(lj), os.path.join(d, "noslab.npz"))
    warned = any("holds no slabs" in str(w.message) for w in seen)
    res.update(restart_outcome(s, None, "noslab_restored"))
    s, *outs = runner.run_sampling(s, write_files=False, nrecords=1)
    res.update(restart_outcome(s, outs, "noslab_resumed"))
    # another R: a ValueError on every rank, and each goes on
    other = dataclasses.replace(lj, ntemp=4, temp=(0.6, 0.8, 1.1, 1.4))
    refused = False
    try:
        runner.restore_setup(fresh(other), os.path.join(d, "one.npz"))
    except ValueError as e:
        refused = "does not fit" in str(e)
    flags = mesh.all_gather(torch.tensor([[int(warned), int(refused)]]))
    if mesh.process_index() == 0:
        np.savez(out, noslab_warned=flags[:, 0].numpy(),
                 wrong_r_refused=flags[:, 1].numpy(), **res)


def gather_outcome(setup, outs, tag):
    """``restart_outcome`` for the gather engine: the gathered states
    (keys included), ``slot_of`` and the lists' reference positions and
    boxes, with the chunk's records, frames, hist and xacc, and every
    rank's diag (ranks,) and ``ENS.COUNTS`` of ``COUNTED`` (ranks, 3) (a
    collective on every rank; in one process, that process's alone)."""
    r = setup.t_grid.shape[0]
    states, slot_of, ref_pos, ref_box = mesh.host_fetch(
        (setup.states, setup.slot_of, setup.nls.ref_pos, setup.nls.ref_box),
        r)
    got = {"s_" + f: getattr(states, f) for f in FIELDS}
    got.update(key=states.key, slot_of=slot_of, ref_pos=ref_pos,
               ref_box=ref_box, counts=mesh.all_gather(torch.tensor(
                   [[ENS.COUNTS[k] for k in COUNTED]])))
    if outs is not None:
        recs, frames, hist, xacc, diag = outs
        got.update({"r_" + k: v for k, v in vars(recs).items()})
        got.update(frame_pos=frames[0], frame_box=frames[1], hist=hist,
                   xacc=xacc, diag=mesh.all_gather(torch.tensor([diag])))
    return {f"{tag}_{k}": v.numpy() for k, v in got.items()}


def gather_setup(d, style):
    return runner.setup_run(GATHER_CFGS[style],
                            setfl=os.path.join(d, TABLE), device="cpu")


def gather_chunk(setup, tag, **kw):
    """One chunk of ``setup`` with the counts reset before it: (setup,
    its ``gather_outcome``)."""
    ENS.reset_counts()
    setup, *outs = runner.run_sampling(setup, write_files=False, **kw)
    return setup, gather_outcome(setup, outs, tag)


def gather(d, out):
    res = {}
    for style in ("lj", "eam"):
        s = gather_setup(d, style)
        ck = os.path.join(d, "two.npz") if style == "lj" else None
        s, got = gather_chunk(s, f"{style}_c0", checkpoint_path=ck)
        res.update(got)
        res.update(gather_chunk(s, f"{style}_c1")[1])
    # LJ's second chunk from the 2-rank, the 1-process and the JAX-layout
    # checkpoints of the first, on fresh set-ups
    for tag in ("two", "one", "noref"):
        with warnings.catch_warnings():
            warnings.simplefilter("error")      # the same config, no warning
            s = runner.restore_setup(gather_setup(d, "lj"),
                                     os.path.join(d, f"{tag}.npz"))
        res.update(gather_chunk(s, f"re_{tag}")[1])
    # rank 0 alone raises CB_INVALID (its margin patched to 0)
    if mesh.process_index() == 0:
        CB.cb_dpos_margin = lambda pops, pot, cellcfg, box: torch.zeros(
            box.shape[:-1])
    res.update(gather_chunk(gather_setup(d, "lj"), "cb", nrecords=1)[1])
    if mesh.process_index() == 0:
        np.savez(out, **res)


def main():
    port, rank, nprocs, mode, inp, out = sys.argv[1:7]
    torch.set_num_threads(1)
    mesh.init_multihost(f"127.0.0.1:{port}", int(nprocs), int(rank),
                        device="cpu")
    try:
        {"chunk": chunk, "c13": c13, "restart": restart,
         "gather": gather}[mode](inp, out)
    finally:
        mesh.shutdown()
    assert "jax" not in sys.modules and "neuralmelting_tpu" not in \
        sys.modules
    print(f"[{rank}] WORKER PASS", flush=True)


if __name__ == "__main__":
    main()
