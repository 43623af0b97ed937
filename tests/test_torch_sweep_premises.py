"""The premises the cell-MC kernels B1-B4 rest on, held on the CPU.

The CUDA sweeps (B2, B3) and totals (B1, B4) walk only the occupied slots
of a neighbour cell, skip the per-pair arithmetic of a candidate outside
the cutoff, and evaluate the Chebyshev series of several functions in one
loop over a common, zero-padded length. The totals take no count: they
derive each cell's count from the packed slab (the number of slots below
INVALID, which is the first INVALID slot). Each is bit-neutral only if:

(a) slots [0, count) of every cell hold finite coordinates (and ids >= 0)
    and slots [count, K) hold INVALID (and id -1), after ``bin_initial``,
    after ``rebin_axis`` on each axis and after a volume trial's
    ``sampler/cellmc.py::_rescale``, for the LJ stride-2 and the EAM
    stride-3 geometry; in the port and, for bin and rebin, in the JAX
    package alike; so the count the totals derive equals ``count``;
(b) the terms the kernels skip are exactly +0.0 in the plain versions:
    ``ops/cellmc.py::_ediff`` when both r^2 >= rc^2 (r^2 = inf for an
    INVALID slot included); the EAM plain sweep's phi and f_rho terms
    outside rc; F(rho + 0) - F(rho); ``ops/cellmc.py::total_plain``'s four
    sums over pairs with r^2 >= max(rc^2, rc^2/s^2); and
    ``ops/cellmc_eam.py::total_plain``'s pair energy, pair virial (phi'),
    embedding virial (f_rho') and densities over pairs outside rc;
(c) a series padded with zero top coefficients gives the bits of the
    unpadded one.

Inputs are seeded numpy grids; every comparison is exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neuralmelting_tpu.ops.pallas import cellmc as CM

import test_torch_eam_case as eam_case
from neuralmelting_tpu_torch.models.lattice import make_supercell
from neuralmelting_tpu_torch.ops import cellmc as CK
from neuralmelting_tpu_torch.ops import cellmc_eam as CE
from neuralmelting_tpu_torch.ops import cellmc_geom as CG
from neuralmelting_tpu_torch.sampler import cellmc as SCm

R = 2
# (lattice, constant, rc, stride, nsub, kcap): the LJ test geometry ((4,4,4)
# cells, K=16) and the EAM one ((3,3,3) cells, K=16)
GEOMS = {"lj": ("fcc", 2.0 ** (2.0 / 3.0), 1.5, 2, 16, 0),
         "eam": ("fcc", 4.05, 3.8, 3, 1, 16)}
STAGES = ("bin", "rebin-x", "rebin-y", "rebin-z")


SHIFT = np.asarray([0.23, 0.61, 0.07], np.float32)


def _port_binned(name):
    """The seeded jittered fcc replicas of GEOMS[name], binned by the port:
    (geom, pos, boxes, (x, y, z, ids), count)."""
    lattice, a0, rc, stride, nsub, kcap = GEOMS[name]
    pos, box = make_supercell(lattice, a0, 4)
    box = np.asarray(box, np.float32)
    g = np.random.default_rng(7)
    jitter = 0.05 * a0 / 2.0 ** (2.0 / 3.0)
    pos = np.stack([(pos + jitter * g.standard_normal(pos.shape)) % box
                    for _ in range(R)]).astype(np.float32)
    boxes = np.repeat(box[None], R, 0)
    geom = CG.make_geom(box, rc, pos.shape[1], nsub=nsub, stride=stride,
                        kcap=kcap)
    x, y, z, ids, count, over = CG.bin_initial(
        geom, torch.as_tensor(pos), torch.as_tensor(boxes),
        torch.as_tensor(SHIFT))
    assert not bool(over)
    return geom, pos, boxes, (x, y, z, ids), count


def _binned(name):
    _, _, rc, stride, nsub, kcap = GEOMS[name]
    geom, pos, boxes, (x, y, z, ids), count = _port_binned(name)
    box = boxes[0]
    gj = CM.make_geom(box, rc, pos.shape[1], nsub=nsub, stride=stride,
                      kcap=kcap)
    assert (geom.ncell, geom.kcap) == (gj.ncell, gj.kcap)
    shift = SHIFT
    jbin = [CM.bin_initial(gj, jnp.asarray(pos[r]), jnp.asarray(boxes[r]),
                           jnp.asarray(shift)) for r in range(R)]
    jslabs = tuple(jnp.stack([b[i] for b in jbin]) for i in range(4))
    jcount = jnp.stack([b[4] for b in jbin])
    return geom, gj, boxes, (x, y, z, ids), count, jslabs, jcount


def _assert_packed(geom, slabs, count, extra=None):
    c, k = geom.ncells, geom.kcap
    occ = (torch.arange(k)[None, None, :]
           < torch.as_tensor(np.array(count))[..., None])   # (R, C, K)
    ids = torch.as_tensor(np.array(slabs[3])).reshape(R, c, k)
    assert bool((ids[occ] >= 0).all()) and bool((ids[~occ] == -1).all())
    for a in slabs[:3]:
        v = torch.as_tensor(np.array(a)).reshape(R, c, k)
        assert v.dtype == torch.float32
        assert bool(torch.isfinite(v[occ]).all())
        assert bool((v[occ] < 0.1 * CG.INVALID).all())
        assert bool((v[~occ] == np.float32(CG.INVALID)).all())
    if extra is not None:
        e = torch.as_tensor(np.array(extra)).reshape(R, c, k)
        assert bool((e[~occ] == 0).all()) and bool((e[occ] > 0).all())


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("name", list(GEOMS))
def test_slots_packed_below_count(name, stage):
    geom, gj, boxes, slabs, count, jslabs, jcount = _binned(name)
    # a per-slot density that travels with its atom (0 in empty slots)
    g = np.random.default_rng(11)
    rho = torch.where(slabs[3] >= 0, torch.as_tensor(
        g.uniform(1.0, 2.0, slabs[3].shape).astype(np.float32)), 0.0)
    jrho = jnp.asarray(rho.numpy())
    _assert_packed(geom, slabs, count)
    _assert_packed(geom, jslabs, jcount)
    nrebin = STAGES.index(stage)
    for axis in range(nrebin):
        delta = np.float32(g.uniform(0.2, 0.9) / geom.ncell[axis])
        tab = CG.geom_tables(geom)[axis]
        slabs, count, over, (rho,) = CG.rebin_axis(
            geom, slabs, count, torch.as_tensor(boxes),
            torch.as_tensor(delta), axis, cell_tab=torch.as_tensor(tab),
            extras=(rho,))
        jslabs, jcount, jover, (jrho,) = CM.rebin_axis(
            gj, jslabs, jcount, jnp.asarray(boxes), jnp.asarray(delta), axis,
            cell_tab=jnp.asarray(tab), extras=(jrho,))
        assert not bool(over) and not bool(jover)
    _assert_packed(geom, slabs, count, rho)
    _assert_packed(geom, jslabs, jcount, jrho)
    np.testing.assert_array_equal(count.numpy(), np.asarray(jcount))
    assert int(count.sum()) == R * geom.natoms


def _beyond(g, rc2, n):
    """n f32 r^2 values >= rc2: rc2 itself, its next float up, and a
    seeded spread up to 100 rc2."""
    v = g.uniform(1.0, 100.0, n).astype(np.float32) * rc2
    v[:2] = [rc2, np.nextafter(rc2, np.float32(np.inf))]
    return v


def _invalid_r2(g, n):
    """r^2 of a candidate parked at INVALID, as the plain version forms
    it (f32): inf."""
    d = np.float32(CG.INVALID) - g.uniform(0.0, 20.0, n).astype(np.float32)
    with np.errstate(over="ignore"):
        r2 = d * d + d * d + d * d
    assert np.isinf(r2).all()
    return r2


@pytest.mark.parametrize("kind", ["beyond", "invalid"])
@pytest.mark.parametrize("rc", [1.5, 2.5])
def test_lj_ediff_is_plus_zero_beyond_rc(rc, kind):
    g = np.random.default_rng(int(rc * 10) + len(kind))
    rc2 = np.float32(rc) * np.float32(rc)
    n = 4096
    if kind == "beyond":
        r2n, r2o = _beyond(g, rc2, n), g.permutation(_beyond(g, rc2, n))
    else:
        # an INVALID slot against a finite r^2 beyond rc, either side, and
        # against another INVALID one
        inf, fin = _invalid_r2(g, n), _beyond(g, rc2, n)
        r2n = np.concatenate([inf, fin, inf])
        r2o = np.concatenate([fin, inf, inf])
    out = CK._ediff(torch.as_tensor(r2n), torch.as_tensor(r2o),
                    torch.tensor(1.0), torch.as_tensor(rc2))
    assert out.dtype == torch.float32
    assert bool((out == 0).all()) and not bool(torch.signbit(out).any())


@pytest.fixture(scope="module")
def pot(tmp_path_factory):
    cheb = eam_case.chebs(eam_case.write_table(
        tmp_path_factory.mktemp("eam_premises")))[1]
    scal, series, nser = CE.eam_pack(cheb, "cpu")
    return CE._Pot(scal, series), series, nser


@pytest.mark.parametrize("seed", [0, 1])
def test_eam_pair_terms_are_plus_zero_outside_rc(pot, seed):
    """phi(u_new) - phi(u_old) and drho = f_rho(u_new) - f_rho(u_old) as
    the plain sweep forms them (one recurrence over the in-cutoff pairs,
    zeros elsewhere): exactly +0.0 where u_old and u_new are both >= rc^2,
    INVALID slots (u = inf) included."""
    p, _, _ = pot
    rc2 = p.rc2.numpy()
    g = np.random.default_rng(seed)
    n = 3000
    uo = (g.uniform(0.3, 3.0, n) * rc2).astype(np.float32)
    un = (uo * g.uniform(0.9, 1.1, n)).astype(np.float32)
    uo[:64] = _invalid_r2(g, 64)
    un[:32] = _invalid_r2(g, 32)
    uo[64:66] = un[64:66] = rc2
    uo, un = torch.as_tensor(uo), torch.as_tensor(un)
    mo, mn = uo < p.rc2, un < p.rc2
    no = int(mo.sum())
    f_u = p.u_series((2, 0), torch.cat([uo[mo], un[mn]]))
    fo, po = CE._on(mo, f_u[:, :no])
    fn, pn = CE._on(mn, f_u[:, no:])
    out = ~mo & ~mn
    assert int(out.sum()) > 100 and int((mo & mn).sum()) > 100
    for term in (pn - po, fn - fo):
        assert bool((term[out] == 0).all())
        assert not bool(torch.signbit(term[out]).any())
    assert bool(torch.isfinite(pn - po).all() & torch.isfinite(fn - fo).all())


def test_eam_embedding_change_is_zero_without_drho(pot):
    """F(rho + 0) - F(rho) is exactly 0 for densities across and beyond
    the table (0, -0, rho_hi and past it included)."""
    p, _, _ = pot
    hi = float(p.rho_hi)
    g = np.random.default_rng(3)
    rho = np.concatenate([g.uniform(0.0, 1.5 * hi, 4000),
                          [0.0, -0.0, hi, 2.0 * hi, 1e-12]]).astype(np.float32)
    rho = torch.as_tensor(rho)
    d = p.femb(rho + torch.zeros_like(rho)) - p.femb(rho)
    assert bool((d == 0).all())


@pytest.mark.parametrize("which", [0, 2, 4])
def test_zero_padded_series_keeps_its_bits(pot, which):
    """clenshaw of c and of c padded with zero top coefficients, to the
    longest of the six series and to 64 terms, at a seeded grid across
    [a, b] and clamped outside it: the same bits."""
    p, series, _ = pot
    c = series[which]
    a, b = (p.q_lo, p.q_hi) if which == 4 else (p.u_lo, p.u_hi)
    g = np.random.default_rng(which)
    lo, hi = float(a), float(b)
    x = torch.as_tensor(g.uniform(lo - 0.1 * (hi - lo), hi + 0.1 * (hi - lo),
                                  5000).astype(np.float32))
    ref = CE.clenshaw(c, a, b, x).numpy().view(np.uint32)
    longest = max(int(s.shape[0]) for s in series)
    for n in sorted({longest, 64}):
        pad = torch.zeros(n, dtype=torch.float32)
        pad[:c.shape[0]] = c
        got = CE.clenshaw(pad, a, b, x).numpy().view(np.uint32)
        np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------------------
# the total kernels B1 and B4: counts derived from the slab, skipped terms
# ---------------------------------------------------------------------------

def _rescaled(slabs, side):
    """A volume trial's _rescale of the three coordinate slabs at a seeded
    scale per replica below (shrink) or above (grow) 1."""
    g = np.random.default_rng(len(side))
    lo, hi = (0.97, 0.995) if side == "shrink" else (1.005, 1.03)
    sca = torch.as_tensor(g.uniform(lo, hi, (R, 1)).astype(np.float32))
    return SCm._rescale(slabs[:3], sca) + (slabs[3],)


@pytest.mark.parametrize("side", ["shrink", "grow"])
@pytest.mark.parametrize("name", list(GEOMS))
def test_slots_packed_after_rescale(name, side):
    geom, _, _, slabs, count = _port_binned(name)
    _assert_packed(geom, _rescaled(slabs, side), count)


def _derived_count(geom, x):
    """Each cell's count as the total kernels derive it: the slots below
    INVALID (ballot and popcount), and the first INVALID slot."""
    v = x.reshape(R, geom.ncells, geom.kcap) < np.float32(0.1 * CG.INVALID)
    pop = v.sum(dim=-1)
    first = torch.where(v.all(dim=-1), geom.kcap,
                        (~v).to(torch.int8).argmax(dim=-1))
    return pop, first


@pytest.mark.parametrize("stage", STAGES + ("rescale",))
@pytest.mark.parametrize("name", list(GEOMS))
def test_kernel_count_equals_count(name, stage):
    """Bin, then the rebins of ``stage`` (all three before a rescale),
    then the rescale: the derived count is count in every cell."""
    geom, _, boxes, slabs, count = _port_binned(name)
    g = np.random.default_rng(13)
    nrebin = 3 if stage == "rescale" else STAGES.index(stage)
    for axis in range(nrebin):
        delta = np.float32(g.uniform(0.2, 0.9) / geom.ncell[axis])
        slabs, count, over = CG.rebin_axis(
            geom, slabs, count, torch.as_tensor(boxes),
            torch.as_tensor(delta), axis,
            cell_tab=torch.as_tensor(CG.geom_tables(geom)[axis]))
        assert not bool(over)
    if stage == "rescale":
        slabs = _rescaled(slabs, "shrink")
    pop, first = _derived_count(geom, slabs[0])
    assert torch.equal(pop.to(torch.int32), count.to(torch.int32))
    assert torch.equal(first.to(torch.int32), count.to(torch.int32))
    assert int((count == 0).sum()) < count.numel()


def _dilute(stride, rc):
    """R replicas of one atom a cell (K=8 slots, seven INVALID) near the
    centre of cells 1.2 rc wide: every pair lies beyond 1.08 rc, so
    beyond rc and beyond rc / s for s >= 0.97. Returns (geom, slabs,
    params)."""
    n = 4 if stride == 2 else 3
    w = 1.2 * rc
    geom = CG.make_geom(np.full(3, n * w), rc, n ** 3,
                        nsub=8 if stride == 2 else 1, stride=stride, kcap=8)
    assert geom.ncell == (n, n, n)
    g = np.random.default_rng(stride)
    first = (np.arange(geom.rows) % geom.kcap == 0)[None]
    tabs = CG.geom_tables(geom)
    slabs = tuple(torch.as_tensor(np.where(
        first, (tabs[a][None] + 0.5 + g.uniform(-0.05, 0.05, (R, geom.rows)))
        * w, CG.INVALID).astype(np.float32)) for a in range(3))
    params = torch.as_tensor(np.concatenate(
        [np.ones((R, 2)), np.full((R, 3), w), np.full((R, 3), n * w)],
        1).astype(np.float32))
    return geom, slabs, params


def _plus_zero(t):
    return bool((t == 0).all()) and not bool(torch.signbit(t).any())


@pytest.mark.parametrize("s", [0.97, 1.03])
@pytest.mark.parametrize("rc", [1.5, 2.5])
def test_lj_total_terms_plus_zero_beyond_cutoffs(rc, s):
    """total_plain's four sums over pairs with r^2 >= max(rc^2, rc^2/s^2)
    (INVALID slots, r^2 = inf, included) are exactly +0, so B1 may leave
    those pairs out of its list."""
    geom, slabs, params = _dilute(2, rc)
    pot3 = torch.tensor([1.0, 1.0, rc, 0.0])
    out = CK.total_plain(geom, slabs, params, pot3, torch.full((R,), s))
    assert _plus_zero(out)


@pytest.mark.parametrize("virial", [False, True])
@pytest.mark.parametrize("s", [0.97, 1.03])
def test_eam_total_terms_plus_zero_outside_rc(pot, s, virial):
    """B4's plain version over pairs with u = (r s)^2 >= rc^2: the pair
    energy (phi), the pair virial (phi') and the embedding virial
    ((F'_i + F'_j) 2u f_rho') are exactly +0, and so is every density."""
    p, series, _ = pot
    rc = float(np.sqrt(float(p.rc2)))
    geom, slabs, params = _dilute(3, rc)
    scal = torch.tensor([float(p.rc2), float(p.u_lo), float(p.u_hi),
                         float(p.q_lo), float(p.q_hi), float(p.rho_hi), 0.0,
                         0.0])
    st, rho = CE.total_plain(geom, slabs, params, scal, series,
                             torch.full((R,), s), virial)
    assert _plus_zero(st[:, [2, 5, 6]]) and _plus_zero(rho)
    assert bool(torch.isfinite(st).all())
