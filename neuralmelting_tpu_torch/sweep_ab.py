"""Same-card A/B of the cell-MC kernels B1-B4 of two trees.

    python3 -m neuralmelting_tpu_torch.sweep_ab OLD_TREE NEW_TREE

runs four readings in the order OLD, NEW, NEW, OLD, each in its own
process with that tree first on the import path (``python3 -P``), so its
kernels are built from that tree's csrc/ into that tree's build/
directory. A tree is a checkout of this repository, for example a
``git archive`` of the parent commit unpacked into a directory that
.gitignore lists. A reading takes, with CUDA events after one warm-up
call, the ms per call of
  * B2 at the LJ north star (profile_chunk.configs()["lj"]: cells
    (8,4,4), K=48, J=16, ncyc=2, R=1024), 5 calls;
  * B1 there at s = 1, 10 calls;
  * B3 at scripts/eambench.py's configuration (configs()["eam"]: cells
    (15,6,6), ncyc=8, R=256) at the set-up K, 3 calls;
  * B4 there, without and with the virial, 10 calls each;
  * B3 (3 calls) and B4 without and with the virial (10 calls each) again
    at the K of the main path's chunks, after one warm-up chunk as
    profile_chunk.py takes it.
Each reading prints one JSON line; the last lines are the card's name and
power limit (nvidia-smi) and one JSON object of all readings. Needs a CUDA
device; imports nothing of jax.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile


def _cuda_ms(fn, reps):
    import torch
    fn()                                         # warm-up
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def measure():
    """One reading of the tree on the import path: {b2_ms, b1_ms, kcap,
    b3_ms, b4_ms, b4v_ms, chunk_kcap, b3_chunk_ms, b4_chunk_ms,
    b4v_chunk_ms}."""
    import torch

    from neuralmelting_tpu_torch import runner
    from neuralmelting_tpu_torch.models import eam_gen
    from neuralmelting_tpu_torch.ops import cellmc as CK
    from neuralmelting_tpu_torch.ops import cellmc_eam as CE
    from neuralmelting_tpu_torch.profile_chunk import configs
    from neuralmelting_tpu_torch.sampler import cellmc as SC

    dev = torch.device("cuda")
    cfgs = configs()
    out = {"tree": os.getcwd()}

    s = runner.setup_run(cfgs["lj"], engine="cellmc", device=dev)
    g, r = s.geom, s.states.temp.shape[0]
    rt = SC.pick_rt(r)
    params = SC.params_of(s.states, g, s.us.kb)
    pot3 = s.pot.pot3(dev)
    seeds = SC.tile_seeds((1, 2), 0, -(-r // rt), dev)
    work = tuple(a.clone() for a in s.slabs[:3])
    out["b2_ms"] = _cuda_ms(lambda: CK.sweep(
        g, SC.default_ncyc(g), rt, work, s.slab_count, params, pot3,
        seeds), 5)
    ones = torch.ones(r, device=dev)
    out["b1_ms"] = _cuda_ms(lambda: CK.total(g, s.slabs[:3], params, pot3,
                                             ones), 10)
    del s, work

    table = os.path.join(tempfile.mkdtemp(prefix="nm_ab_"), "al38.eam.alloy")
    eam_gen.write_setfl(table, rc=3.8)
    s = runner.setup_run(cfgs["eam"], setfl=table, engine="cellmc",
                         device=dev)
    r = s.states.temp.shape[0]
    rt = SC.pick_rt(r)
    ones = torch.ones(r, device=dev)
    scal, series, _ = CE.eam_pack(s.pot, dev)
    seeds = SC.tile_seeds((1, 2), 0, -(-r // rt), dev)

    def b3_ms(st):
        gk = st.geom
        params = SC.params_of(st.states, gk, st.us.kb)
        work = tuple(a.clone() for a in st.slabs[:3] + st.slabs[4:])
        return _cuda_ms(lambda: CE.sweep(
            gk, SC.default_ncyc(gk), rt, work, st.slab_count, params, scal,
            series, seeds), 3)

    def b4_ms(st, virial):
        params = SC.params_of(st.states, st.geom, st.us.kb)
        return _cuda_ms(lambda: CE.total(st.geom, st.slabs[:3], params, scal,
                                         series, ones, virial), 10)

    out["kcap"], out["b3_ms"] = s.geom.kcap, b3_ms(s)
    out["b4_ms"], out["b4v_ms"] = b4_ms(s, False), b4_ms(s, True)
    warm = runner.run_sampling(s, write_traj=False)[0]
    out["chunk_kcap"], out["b3_chunk_ms"] = warm.geom.kcap, b3_ms(warm)
    out["b4_chunk_ms"] = b4_ms(warm, False)
    out["b4v_chunk_ms"] = b4_ms(warm, True)
    return out


def _card():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return res.stdout.strip() if res.returncode == 0 else "nvidia-smi failed"


def main(argv):
    if argv[:1] == ["--one"]:
        print(json.dumps(measure()), flush=True)
        return 0
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    old, new = (os.path.abspath(t) for t in argv)
    readings = []
    for tag, tree in (("old", old), ("new", new), ("new", new),
                      ("old", old)):
        env = dict(os.environ, PYTHONPATH=tree)
        res = subprocess.run([sys.executable, "-P", os.path.abspath(__file__),
                              "--one"], cwd=tree, env=env,
                             capture_output=True, text=True, timeout=1200)
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            return 1
        reading = dict(json.loads(res.stdout.strip().splitlines()[-1]),
                       side=tag)
        print(json.dumps(reading), flush=True)
        readings.append(reading)
    print(_card())
    print(json.dumps({"readings": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
