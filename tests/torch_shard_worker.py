"""One port rank of the two-process tests (test_torch_sharded_*.py,
test_torch_multiproc.py); this module holds no tests and imports nothing
of JAX or of the JAX package.

    python tests/torch_shard_worker.py <port> <rank> <nprocs> <mode> <in.npz> <out.npz>

mode "chunk": join the gloo group on 127.0.0.1:<port>, take this rank's
shard of the whole-R inputs in <in.npz> (written by
tests/torch_chunk_case.py ``save_inputs``), run one chunk of
parallel/cellmc_sharded.py and let rank 0 write the gathered outputs.
mode "c13": the refusals under two processes (the gather engine,
``restore_setup``, ``exchange=False``) and a chunk in which the two ranks
raise different diag bits; rank 0 writes what it saw.
"""

import os
import sys

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
from neuralmelting_tpu_torch.parallel import mesh  # noqa: E402
from neuralmelting_tpu_torch.sampler import cellmc as SC  # noqa: E402
from neuralmelting_tpu_torch.sampler.state import (FIELDS,  # noqa: E402
                                                   state_from_numpy)

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
    for what, call in (
            ("gather", lambda: runner.setup_run(cfg, device="cpu")),
            ("restore", lambda: runner.restore_setup(
                runner.setup_run(cfg, engine="cellmc", device="cpu"),
                "none.npz")),
            ("no_exchange", lambda: runner.run_sampling(
                runner.setup_run(cfg, engine="cellmc", device="cpu"),
                exchange=False))):
        try:
            call()
        except NotImplementedError as e:
            if "A12 (rest)" in str(e):
                seen.append(what)
    # the two ranks raise different bits: CB_INVALID on rank 0,
    # SLAB_OVERFLOW on rank 1
    bit = (SC.DIAG_CB_INVALID, SC.DIAG_SLAB_OVERFLOW)[rank]
    SC._cells_cover = lambda states, geom, rc2: torch.tensor(bit)
    c = load_inputs(inp)
    out_ = run_chunk(c)[0]
    if rank == 0:
        np.savez(out, refused=np.asarray(seen), diag=int(out_[9]))


def main():
    port, rank, nprocs, mode, inp, out = sys.argv[1:7]
    torch.set_num_threads(1)
    mesh.init_multihost(f"127.0.0.1:{port}", int(nprocs), int(rank),
                        device="cpu")
    try:
        {"chunk": chunk, "c13": c13}[mode](inp, out)
    finally:
        mesh.shutdown()
    assert "jax" not in sys.modules and "neuralmelting_tpu" not in \
        sys.modules
    print(f"[{rank}] WORKER PASS", flush=True)


if __name__ == "__main__":
    main()
