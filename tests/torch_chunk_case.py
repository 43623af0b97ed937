"""Inputs shared by the cellmc chunk parity tests
(test_torch_cellmc_chunk.py, test_torch_sharded_*.py,
test_torch_multiproc.py); this module holds no tests.

An LJ case (256-atom fcc at rc 1.5: (4, 4, 4) cells, K=16, J=4, so that
the JAX Pallas kernels compile in interpret mode in tens of seconds) and
an EAM case (tests/test_torch_eam_case.py's 256 Al atoms at rc 3.8:
(3, 3, 3) cells, K=16), each with R = 4 jittered replicas on a 2 x 2
(P, T) grid. The port builds the ensemble (slabs, exact pe, virial and
the density slab), and the JAX side gets the same numbers
(``jax_inputs``); ``save_inputs`` writes them for the port's ranks
(tests/torch_shard_worker.py). ``compare`` holds a chunk's outcome to
JAX's: the decisions bit for bit, the continuous values within the
tolerances below.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import torch

import jax
import jax.numpy as jnp

from neuralmelting_tpu.models.lj import LJCut as JLJ
from neuralmelting_tpu.ops.pallas import cellmc as CM
from neuralmelting_tpu.sampler.state import ensemble_init as jax_init
from neuralmelting_tpu_torch import units
from neuralmelting_tpu_torch.models.lattice import make_supercell
from neuralmelting_tpu_torch.models.lj import LJCut
from neuralmelting_tpu_torch.ops import cellmc_eam as CE
from neuralmelting_tpu_torch.ops import cellmc_geom as CG
from neuralmelting_tpu_torch.sampler import cellmc as SC
from neuralmelting_tpu_torch.sampler.state import FIELDS, ensemble_init

import test_torch_eam_case as eam_case

RC = 1.5
NPRESS, NTEMP = 2, 2
R = NPRESS * NTEMP
SEED0 = (11, 5)
XKEY = 23
# the chunk: 2 records of 2 sweeps, one volume trial and one rebin every
# sweep, counters accumulated over the chunk (adapt off)
RUN = dict(mod=2, nrecords=2, npress=NPRESS, ntemp=NTEMP, ncyc=1, nvol=1,
           vol_every=1, rebin_every=1, adapt=False)
# f32 tolerances: B1/B4 sum in another order than the interpret-mode
# kernels (pe, virial), and pow(x, 1/3) is within 1 ulp of jnp.cbrt
# (box, positions through the volume rescale)
PE_RTOL = 2e-5
BOX_RTOL = 2e-6
POS_ATOL = 1e-4
DECISIONS = ("nap", "ntp", "nav", "ntv", "sweep")


def lj_case(seed=3):
    pot = LJCut.create(1.0, 1.0, RC)
    pos0, box = make_supercell("fcc", 2.0 ** (2.0 / 3.0), 4)
    temps = np.tile(np.linspace(0.8, 1.2, NTEMP), NPRESS)
    press = np.repeat(np.asarray([1.0, 3.0]), NTEMP)
    geom = CG.make_geom(box, RC, len(pos0), nsub=4)
    assert geom.ncell == (4, 4, 4) and geom.kcap == 16
    states, slabs, count = _ensemble(pos0, box, temps, press, geom, seed,
                                     0.03, dpos0=0.1, dvol0=0.01)
    states = SC.refresh_energies(geom, states, slabs, pot)
    return dict(style="pair", pot=pot, geom=geom, states=states,
                slabs=slabs, count=count, kb=1.0, p2e=1.0,
                jgeom=CM.make_geom(box, RC, len(pos0), nsub=4))


def eam_case_inputs(directory, seed=4):
    jcheb, cheb = eam_case.chebs(eam_case.write_table(directory))
    pos0, box = make_supercell("fcc", 4.05, (4, 4, 4))
    temps = np.tile(np.linspace(600.0, 1400.0, NTEMP), NPRESS)
    press = np.repeat(np.asarray([1.0, 5000.0]), NTEMP)
    geom = CG.make_geom(box, cheb.rc_host, len(pos0), nsub=1, stride=3,
                        kcap=16)
    assert geom.ncell == (3, 3, 3)
    states, slabs, count = _ensemble(pos0, box, temps, press, geom, seed,
                                     0.08, dpos0=0.15, dvol0=0.002)
    scal, series, _ = CE.eam_pack(cheb, "cpu")
    states, rho = SC.eam_initial_rho(geom, states, slabs, scal, series)
    return dict(style="eam", pot=cheb, jpot=jcheb, geom=geom, states=states,
                slabs=tuple(slabs) + (rho,), count=count,
                kb=units.METAL.kb, p2e=units.METAL.p2e,
                jgeom=CM.make_geom(box, 3.8, 256, nsub=1, stride=3,
                                   kcap=16))


def _ensemble(pos0, box, temps, press, geom, seed, jitter, dpos0, dvol0):
    g = np.random.default_rng(seed)
    box = np.asarray(box, np.float32)
    pos = np.stack([(pos0 + jitter * g.standard_normal(pos0.shape)) % box
                    for _ in range(R)]).astype(np.float32)
    states = ensemble_init(pos0, box, temps, press, dpos0=dpos0,
                           dvol_frac0=dvol0, dt0=0.005)
    states = states.replace(pos=torch.as_tensor(pos))
    slabs, count, over = SC.build_slabs(geom, states, torch.zeros(3))
    assert not bool(over)
    return states, slabs, count


def t_grid(c):
    return c["states"].temp.clone()


def p_grid(c):
    return c["states"].press.clone()


def jax_inputs(c):
    """The case as the JAX runner's arguments: (states, slabs, count,
    shift, cell_tabs, t_grid, p_grid)."""
    s = c["states"]
    js = jax_init(JLJ.create(), s.pos[0].numpy(), s.box[0].numpy(), 1,
                  jnp.asarray(s.temp.numpy()), jnp.asarray(s.press.numpy()),
                  dpos0=0.1, dvol_frac0=0.01, dt0=0.005,
                  energy_fn=lambda p, a, b: (jnp.zeros(()), jnp.zeros(())))
    js = js.replace(**{f: jnp.asarray(getattr(s, f).numpy())
                       for f in FIELDS})
    slabs = tuple(jnp.asarray(a.numpy()) for a in c["slabs"])
    tabs = CM.geom_tables(c["jgeom"])
    np.testing.assert_array_equal(tabs, CG.geom_tables(c["geom"]))
    return (js, slabs, jnp.asarray(c["count"].numpy()),
            jnp.zeros((3,), jnp.float32), jnp.asarray(tabs),
            jnp.asarray(t_grid(c).numpy()), jnp.asarray(p_grid(c).numpy()))


def save_inputs(path, c):
    """The case for tests/torch_shard_worker.py."""
    g = c["geom"]
    arrays = {"s_" + f: getattr(c["states"], f).numpy() for f in FIELDS}
    arrays.update({f"sl_{i}": a.numpy() for i, a in enumerate(c["slabs"])})
    if c["style"] == "eam":
        arrays.update({"p_" + k: np.asarray(getattr(c["pot"], k))
                       for k in ("rc", "u_lo", "u_hi", "rho_hi", "q_lo",
                                 "c_phi", "c_phid", "c_rho", "c_rhod",
                                 "c_f", "c_fd")})
    else:
        arrays["lj"] = np.asarray([1.0, 1.0, RC])
    np.savez(path, nslabs=len(c["slabs"]), style=c["style"],
             geom=np.asarray(list(g.ncell) + [g.kcap, g.nsub, g.stride,
                                              g.natoms]),
             count=c["count"].numpy(), shift=np.zeros(3, np.float32),
             slot_of=np.arange(R, dtype=np.int32),
             t_grid=t_grid(c).numpy(), p_grid=p_grid(c).numpy(),
             cell_tabs=CG.geom_tables(g), kb=c["kb"], p2e=c["p2e"],
             run=np.asarray([int(RUN[k]) for k in (
                 "mod", "nrecords", "npress", "ntemp", "ncyc", "nvol",
                 "vol_every", "rebin_every", "adapt")]),
             seed0=np.asarray(SEED0), xkey=XKEY, **arrays)


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def start_ranks(mode, inp, out, nprocs=2):
    """Start the port's ranks (tests/torch_shard_worker.py), one thread
    each; returns the processes."""
    worker = os.path.join(os.path.dirname(__file__), "torch_shard_worker.py")
    port = str(free_port())
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, worker, port, str(i),
                              str(nprocs), mode, str(inp), str(out)],
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, env=env)
            for i in range(nprocs)]


def wait_ranks(procs, timeout=240):
    """Wait for every rank; a rank that fails or runs out of time fails
    the test with its output."""
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=timeout)[0].decode())
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise AssertionError("a rank ran out of time:\n"
                                 + p.communicate()[0].decode()[-3000:])
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and "WORKER PASS" in out, \
            f"rank {i} failed:\n{out[-3000:]}"


def compare(port, jax_out):
    """Hold a chunk's outcome (dicts of numpy arrays: ``s_<field>`` final
    states, ``r_<field>`` records (nrec, R), shift, slot_of, hist, xacc,
    diag) to JAX's."""
    assert int(port["diag"]) == int(jax_out["diag"]) == 0
    for k in ("shift", "slot_of", "hist", "xacc"):
        a, b = np.asarray(port[k]), np.asarray(jax_out[k])
        assert a.shape == b.shape, k
        np.testing.assert_array_equal(a.view(np.int32) if a.dtype ==
                                      np.float32 else a,
                                      b.view(np.int32) if b.dtype ==
                                      np.float32 else b, err_msg=k)
    for f in DECISIONS:
        np.testing.assert_array_equal(port["s_" + f], jax_out["s_" + f],
                                      err_msg=f)
    assert int(np.sum(port["s_nap"])) > 0 and int(np.sum(port["s_nav"])) > 0
    for f in ("acc_pos", "acc_vol", "sweep"):
        np.testing.assert_array_equal(port["r_" + f], jax_out["r_" + f],
                                      err_msg=f)
    np.testing.assert_allclose(port["s_pe"], jax_out["s_pe"], rtol=PE_RTOL)
    np.testing.assert_allclose(port["r_pe"], jax_out["r_pe"], rtol=PE_RTOL)
    np.testing.assert_allclose(port["s_box"], jax_out["s_box"],
                               rtol=BOX_RTOL)
    np.testing.assert_allclose(port["r_vol"], jax_out["r_vol"],
                               rtol=3 * BOX_RTOL)
    np.testing.assert_allclose(port["s_pos"], jax_out["s_pos"], rtol=0,
                               atol=POS_ATOL)


def jax_outcome(out):
    """The JAX runner's 10-tuple as ``compare``'s dict."""
    states, _, _, shift, slot_of, recs, _, hist, xacc, diag = out
    d = {"s_" + f: np.asarray(getattr(states, f)) for f in FIELDS}
    d.update({"r_" + f: np.asarray(getattr(recs, f))
              for f in ("pe", "vol", "acc_pos", "acc_vol", "sweep")})
    d.update(shift=np.asarray(shift), slot_of=np.asarray(slot_of),
             hist=np.asarray(hist), xacc=np.asarray(xacc),
             diag=int(diag))
    return d


def port_outcome(out):
    """The port's exchange runner's 11-tuple as ``compare``'s dict."""
    states, _, _, shift, slot_of, recs, _, hist, xacc, diag, _ = out
    d = {"s_" + f: getattr(states, f).numpy() for f in FIELDS}
    d.update({"r_" + f: getattr(recs, f).numpy()
              for f in ("pe", "vol", "acc_pos", "acc_vol", "sweep")})
    d.update(shift=shift.numpy(), slot_of=slot_of.numpy(),
             hist=hist.numpy(), xacc=xacc.numpy(), diag=int(diag))
    return d


def sharded_matches_jax(c, tmp_path):
    """The port's sharded runner on two gloo ranks against the JAX
    package's ``make_sharded_cellmc_run_fn`` on a 2-device slice of the
    conftest's virtual CPU devices, on the case ``c``. The ranks start
    first and run while the JAX side compiles."""
    from neuralmelting_tpu.parallel import cellmc_sharded as JCS
    from neuralmelting_tpu.parallel import mesh as JM
    from neuralmelting_tpu.sampler import cellmc as JSC

    inp, out = tmp_path / "in.npz", tmp_path / "out.npz"
    save_inputs(inp, c)
    procs = start_ranks("chunk", inp, out)
    try:
        gmesh = JM.make_replica_mesh(jax.devices()[:2])
        states, slabs, count, shift, tabs, tg, pg = jax_inputs(c)
        states = JM.shard_ensemble(gmesh, states)
        slabs = tuple(JM.shard_ensemble(gmesh, s) for s in slabs)
        count = JM.shard_ensemble(gmesh, count)
        kw = dict(RUN)
        if c["style"] == "eam":
            scal, series, nser = JSC.eam_pack(c["jpot"])
            potp = (scal, series)
        else:
            nser, potp = None, (JLJ.create(1.0, 1.0, RC),)
        run = JCS.make_sharded_cellmc_run_fn(
            gmesh, c["kb"], c["p2e"], c["jgeom"], style=c["style"],
            nser=nser, **kw)
        jout = run(states, slabs, count, shift,
                   jnp.arange(R, dtype=jnp.int32), jax.random.key(XKEY),
                   *potp, tabs, tg, pg, jnp.asarray(SEED0, jnp.int32))
        want = jax_outcome(jout)
    finally:
        wait_ranks(procs)
    got = dict(np.load(out))
    assert got["hist"].shape == (RUN["nrecords"], R)   # gathered, whole
    compare(got, want)
