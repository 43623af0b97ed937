"""Port parity: one LJ exchange chunk of the cellmc engine
(sampler/cellmc.py ``make_cellmc_run_fn``, kernels B1/B2 through their
plain versions on the CPU) against the JAX package's
``make_cellmc_run_fn`` with its Pallas kernels in interpret mode, on the
same inputs (tests/torch_chunk_case.py: 256-atom fcc, R = 4 on a 2 x 2
(P, T) grid, 2 records of 2 sweeps).

The host draws are the JAX key chain (key(1) for an exchange chunk) and
the kernels' threefry stream is the same, so every decision is equal:
bit for bit ``shift``, ``slot_of``, ``hist``, ``xacc``, the move counters
and the records' acceptance ratios; pe, box and positions within
torch_chunk_case's f32 tolerances.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from neuralmelting_tpu.models.lj import LJCut as JLJ
from neuralmelting_tpu.sampler import cellmc as JSC
from neuralmelting_tpu_torch.ops import jrandom
from neuralmelting_tpu_torch.sampler import cellmc as SC

import torch_chunk_case as CC


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_lj_exchange_chunk_matches_jax():
    c = CC.lj_case()
    kw = {k: v for k, v in CC.RUN.items()}
    run = SC.make_cellmc_run_fn(c["kb"], c["p2e"], c["geom"], exchange=True,
                                **kw)
    states, slabs, count, shift, tabs, tg, pg = CC.jax_inputs(c)
    port = CC.port_outcome(run(
        c["states"].clone(), tuple(a.clone() for a in c["slabs"]),
        c["count"].clone(), torch.zeros(3), torch.arange(CC.R,
                                                          dtype=torch.int32),
        jrandom.key(CC.XKEY), c["pot"], torch.as_tensor(
            CC.CG.geom_tables(c["geom"])), CC.t_grid(c), CC.p_grid(c),
        CC.SEED0))
    jrun = JSC.make_cellmc_run_fn(c["kb"], c["p2e"], c["jgeom"],
                                  exchange=True, interpret=True, **kw)
    jout = jrun(states, slabs, count, shift,
                jnp.arange(CC.R, dtype=jnp.int32), jax.random.key(CC.XKEY),
                JLJ.create(1.0, 1.0, CC.RC), tabs, tg, pg,
                jnp.asarray(CC.SEED0, jnp.int32))
    CC.compare(port, CC.jax_outcome(jout))
