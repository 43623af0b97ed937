"""Stage 1 — REMCMC sampling (reference: lammps_remcmc.py; counterpart of
``neuralmelting_tpu.cli.remcmc``).

Runs the replica-exchange NPT Monte Carlo ensemble on the card (or on
``--device cpu``) and writes per-(P,T) .thrm/.traj text files, a
checkpoint and ``metrics.jsonl``; the last line printed is a JSON summary.

    python -m neuralmelting_tpu_torch.cli.remcmc -e LJ -ss 4 -pn 4 -tn 16 -o out/

With ``--coordinator HOST:PORT --nprocs N --procid I`` (one process per
device, each started with its own ``--procid``) each process samples its
shard of the replicas, on the default gather engine (rebuild decisions
and the exchange agreed over the processes: the run makes one process's
decisions) or on cellmc (parallel/cellmc_sharded.py), and process 0
alone writes the files and prints the summary; ``--restart`` resumes a
checkpoint of one process or of several, and ``--profile`` writes one
trace a process.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

from neuralmelting_tpu_torch import runner
from neuralmelting_tpu_torch.cli.common import add_run_args, config_from_args
from neuralmelting_tpu_torch.parallel import mesh
from neuralmelting_tpu_torch.utils import MetricsLogger


def _trace(profile_dir):
    """A torch.profiler context writing a Chrome trace into
    ``profile_dir`` on exit, or a null context: ``remcmc.trace.json``,
    and under more than one process one a rank,
    ``remcmc.rank<I>.trace.json``."""
    if not profile_dir:
        return contextlib.nullcontext()
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    name = ("remcmc.trace.json" if mesh.process_count() == 1
            else f"remcmc.rank{mesh.process_index()}.trace.json")

    def write(prof):
        prof.export_chrome_trace(os.path.join(profile_dir, name))

    return profile(activities=acts, on_trace_ready=write)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    add_run_args(ap)
    ap.add_argument("-o", "--outdir", default="output")
    ap.add_argument("--no-traj", action="store_true")
    ap.add_argument("--engine", default="gather",
                    choices=("gather", "dense", "cellmc"),
                    help="gather (default) = checkerboard passes over "
                         "neighbour lists, LJ and EAM, the only engine with "
                         "HMC (--phmc); cellmc = the cell-MC CUDA kernels (LJ "
                         "stride-2, EAM stride-3 Chebyshev); dense = "
                         "checkerboard passes with trial energies against "
                         "every atom and its ghost images (LJ, one process)")
    ap.add_argument("--restart", default=None,
                    help="checkpoint .npz to resume from")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler Chrome trace of the run "
                         "into DIR")
    ap.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                    help="multi-process runs: the address of process 0's "
                         "torch.distributed store; start one process per "
                         "device with --nprocs/--procid. Each process "
                         "samples its shard of the replicas on either "
                         "engine (gather, the default, makes the "
                         "decisions of one process), process 0 writes "
                         "all outputs; the "
                         "device is cuda:<local rank> (LOCAL_RANK, else "
                         "procid, modulo the node's cards) unless "
                         "--device names one. NCCL where each process of "
                         "a node owns its card, else gloo")
    ap.add_argument("--nprocs", type=int, default=None)
    ap.add_argument("--procid", type=int, default=None)
    args = ap.parse_args(argv)
    if (args.coordinator is None) != (args.nprocs is None) or \
            (args.nprocs is None) != (args.procid is None):
        raise ValueError("a multi-process run needs --coordinator, "
                         "--nprocs and --procid together")
    if args.coordinator:
        args.device = mesh.rank_device(args.device, args.nprocs,
                                       args.procid)
        mesh.init_multihost(args.coordinator, args.nprocs, args.procid,
                            device=args.device)
    try:
        _run(args)
    finally:
        mesh.shutdown()


def _run(args):
    cfg = config_from_args(args)

    t0 = time.time()
    setup = runner.setup_run(cfg, setfl=args.setfl, engine=args.engine,
                             device=args.device)
    if args.restart:
        setup = runner.restore_setup(setup, args.restart)
        print(f"resumed from {args.restart}")
    os.makedirs(args.outdir, exist_ok=True)
    ckpath = os.path.join(args.outdir,
                          f"{cfg.name}.{cfg.element.lower()}.ckpt.npz")
    metrics = MetricsLogger(os.path.join(args.outdir, "metrics.jsonl"),
                            run_id=cfg.name)
    with _trace(args.profile):
        setup, recs, frames, hist, xacc, diag = runner.run_sampling(
            setup, outdir=args.outdir, checkpoint_path=ckpath,
            write_traj=not args.no_traj, metrics=metrics)
    if args.profile:
        print(f"profiler trace written to {args.profile}")
    r = len(setup.press) * len(setup.temp)
    ntp = mesh.host_fetch(setup.states.ntp, r)    # a collective
    if mesh.process_index() != 0:
        return
    print(json.dumps({
        "outdir": args.outdir, "records": int(cfg.nsmpl),
        "replicas": int(r), "natoms": setup.natoms, "diag": int(diag),
        "attempted_position_moves": int(ntp.sum()),
        "exchange_acceptances": [int(x) for x in xacc.tolist()],
        "seconds": round(time.time() - t0, 2),
    }))


if __name__ == "__main__":
    main()
