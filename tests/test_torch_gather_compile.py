"""The gather engine's colour substep, traced whole by torch.compile.

On the card a pass's colour substeps run through
``checkerboard.compiled_colour_step`` (Inductor); chip_smoke holds that
pass to the eager one there. Here, on the CPU, the same function is
traced with ``fullgraph=True`` (a graph break fails) and run through the
``aot_eager`` backend, which runs the traced operations as they are: a
pass with it equals the eager pass bit for bit, for LJ (108 atoms) and for
EAM (256 Al atoms on the rc 3.8 table). A pass on CPU tensors takes the
eager substep whatever ``compiled`` says.
"""

import pytest
import torch

from neuralmelting_tpu_torch import runner
from neuralmelting_tpu_torch.config import RunConfig
from neuralmelting_tpu_torch.models import eam_gen
from neuralmelting_tpu_torch.ops import jrandom
from neuralmelting_tpu_torch.sampler import checkerboard as CB

_LJ = dict(name="gc", element="LJ", ncells=(3, 3, 3), npress=2, ntemp=2,
           press=(1.0, 1.3), temp=(0.8, 0.84), nsmpl=1, mod=1, ncut=0,
           seed=3)
_AL = dict(name="gca", element="AL", ncells=(4, 4, 4), npress=1, ntemp=2,
           press=(1.0,), temp=(900.0, 1000.0), nsmpl=1, mod=1, ncut=0,
           seed=5, dpos0=0.1, dvol0=0.01)


@pytest.fixture(scope="module")
def table(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("eam") / "al38.eam.alloy")
    eam_gen.write_setfl(path, rc=3.8)
    return path


def _pass(setup, trace, step=None):
    """One pass of ``setup``'s ensemble from its state, with the colour
    substep ``step`` in place of the eager one."""
    st, cc = setup.states, setup.cellcfg
    kd = jrandom.fold_in(st.key, 3)
    one_pass = CB.make_cb_pass_fn(setup.us.kb, cc, setup.style)
    eager = CB.colour_step
    if step is not None:
        CB.colour_step = step
    try:
        return one_pass(setup.pot, setup.table, st, setup.nls, setup.aux,
                        st.dpos, kd, trace=trace)
    finally:
        CB.colour_step = eager


@pytest.mark.parametrize("kind", ["LJ", "AL"])
def test_colour_step_traces_whole_and_keeps_the_bits(kind, table):
    cfg = RunConfig(**(_LJ if kind == "LJ" else _AL))
    setup = runner.setup_run(cfg, setfl=table if kind == "AL" else None,
                             device="cpu")
    # a chunk first, so the pass starts from a sampled state
    setup = runner.run_sampling(setup, write_files=False)[0]
    traced = torch.compile(CB.colour_step, fullgraph=True,
                           backend="aot_eager")
    te, tt = [], []
    se, ae = _pass(setup, te)
    st, at = _pass(setup, tt, step=traced)
    for f in ("pos", "pe", "virial", "nap", "ntp"):
        assert torch.equal(getattr(se, f), getattr(st, f)), f
    assert torch.equal(ae, at)
    assert all(torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
               for a, b in zip(te, tt))
    assert sum(int(a[1].sum()) for a in te) > 0


def test_cpu_pass_takes_the_eager_step(monkeypatch):
    def refuse():
        raise AssertionError("compiled a substep for CPU tensors")

    monkeypatch.setattr(CB, "compiled_colour_step", refuse)
    setup = runner.setup_run(RunConfig(**_LJ), device="cpu")
    st, _ = _pass(setup, None)
    assert torch.isfinite(st.pe).all()
