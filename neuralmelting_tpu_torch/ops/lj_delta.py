"""Kernel B5: brute-force LJ energy and virial changes of trial moves.

Counterpart of the Pallas TPU kernel ``delta_moves_pallas``
(``neuralmelting_tpu/ops/pallas/lj_kernel.py``): for M movers of each of R
replicas, the minimum-image LJ dE = E(new) - E(old) of the mover against
all N atoms of its replica, itself excluded, inside rc, with r^2 floored
at 1e-4. In the same pass it computes dW, the pair-virial change that
``ops/energy.py::delta_move_brute`` returns beside dE and that the serial
engine's records read.

Two entry points, each a hand-written CUDA kernel (``csrc/lj_delta.cu``)
for CUDA tensors and a plain version for CPU tensors, the tests and
``chip_smoke.py``:

- ``delta_moves`` (R, M) -> (dE, dW), the batched form;
- ``position_run``: one chain's run of A consecutive position attempts,
  decided and applied in order in one launch, as A calls of
  ``sampler/moves.py::position`` with ``brute_backend()`` in a row. The
  serial sweep (``sampler/serial.py``) launches it once per run.

No fallback: a CUDA tensor launches the kernel or raises; every other
device is refused. ``LAUNCHES["delta"]`` counts kernel launches of both,
``LAUNCHES["delta_attempts"]`` the attempts that went through the run
kernel.

Shapes: pos (R, N, 3) f32, box (R, 3) f32, ids (R, M) int32, old_r and
new_r (R, M, 3) f32 -> (dE, dW), each (R, M) f32. Each pair term has
``LJCut.pair_e_w``'s f32 operations in both forms, so per pair they agree
bit for bit; the plain version sums over N in another order. The two
kernels sum in one order, so a mover's dE and dW have the same bits in
``delta_moves`` at any (R, M) and in ``position_run``.
"""

from __future__ import annotations

import torch

from neuralmelting_tpu_torch.ops.energy import min_image

LAUNCHES = {"delta": 0, "delta_attempts": 0}
R2_FLOOR = 1e-4
# shared memory a Hopper block can take (the kernels stage 12 N bytes)
_MAX_SMEM = 232448


def reset_launches():
    LAUNCHES["delta"] = LAUNCHES["delta_attempts"] = 0


def _device(pos):
    if pos.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no B5 kernel for device {pos.device}")
    return pos.device


def delta_moves(pot, pos, box, ids, old_r, new_r):
    """(dE, dW), each (R, M): B5 on a CUDA tensor, the plain version on a
    CPU tensor."""
    dev = _device(pos)
    r, n, _ = pos.shape
    m = ids.shape[1]
    _check("pos", pos, (r, n, 3), torch.float32, dev)
    _check("box", box, (r, 3), torch.float32, dev)
    _check("ids", ids, (r, m), torch.int32, dev)
    _check("old_r", old_r, (r, m, 3), torch.float32, dev)
    _check("new_r", new_r, (r, m, 3), torch.float32, dev)
    if dev.type == "cpu":
        return delta_moves_plain(pot, pos, box, ids, old_r, new_r)
    return _delta_cuda(pot, pos, box, ids, old_r, new_r)


def position_run(pot, pos, box, ids, disp, ln_u, nbeta, pe, virial):
    """A run of A position attempts of one chain, in order: (acc (A,)
    bool, weight (A,) f32). Attempt k moves atom ``ids[k]`` by ``disp[k]``
    (``moves.displacement``), weight = nbeta dE, and accepts iff ln_u[k] <
    weight; an accepted position is wrapped into the box. Updates ``pos``
    (N, 3), ``pe`` and ``virial`` (0-dim) in place. ``box`` (3,), ``ids``
    (A,) int32, ``disp`` (A, 3), ``ln_u`` (A,) and ``nbeta`` (0-dim) on the
    same device. One launch of B5's run kernel on CUDA tensors, the plain
    version on CPU tensors."""
    dev = _device(pos)
    n, a = pos.shape[0], ids.shape[0]
    _check("pos", pos, (n, 3), torch.float32, dev)
    _check("box", box, (3,), torch.float32, dev)
    _check("ids", ids, (a,), torch.int32, dev)
    _check("disp", disp, (a, 3), torch.float32, dev)
    _check("ln_u", ln_u, (a,), torch.float32, dev)
    for name, t in (("nbeta", nbeta), ("pe", pe), ("virial", virial)):
        _check(name, t, (), torch.float32, dev)
    if dev.type == "cpu":
        return position_run_plain(pot, pos, box, ids, disp, ln_u, nbeta, pe,
                                  virial)
    return _run_cuda(pot, pos, box, ids, disp, ln_u, nbeta, pe, virial)


def _check(name, t, shape, dtype, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if t.device != device or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous on {device}")


def _load(n):
    """The kernel library, after checking that N atoms fit in shared
    memory."""
    from neuralmelting_tpu_torch.ops import _build
    lib = _build.load()
    smem = lib.nm_lj_delta_smem(n) + lib.nm_lj_delta_static_smem()
    if smem > _MAX_SMEM:
        raise ValueError(f"B5 stages {n} atoms in {smem} B of shared "
                         f"memory, more than a block has ({_MAX_SMEM} B)")
    return lib


def _delta_cuda(pot, pos, box, ids, old_r, new_r):
    r, n, _ = pos.shape
    m = ids.shape[1]
    dev = pos.device
    out = torch.empty((2, r, m), dtype=torch.float32, device=dev)
    sig2, rc2, e4, w24 = pot.f32_consts()
    lib = _load(n)
    with torch.cuda.device(dev):
        err = lib.nm_lj_delta(
            pos.data_ptr(), box.data_ptr(), ids.data_ptr(),
            old_r.data_ptr(), new_r.data_ptr(), out.data_ptr(), r, n, m,
            sig2, rc2, e4, w24, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"B5 kernel launch failed: CUDA error {err}")
    LAUNCHES["delta"] += 1
    return out[0], out[1]


def _run_cuda(pot, pos, box, ids, disp, ln_u, nbeta, pe, virial):
    n, a = pos.shape[0], ids.shape[0]
    dev = pos.device
    acc = torch.empty(a, dtype=torch.bool, device=dev)
    weight = torch.empty(a, dtype=torch.float32, device=dev)
    sig2, rc2, e4, w24 = pot.f32_consts()
    lib = _load(n)
    with torch.cuda.device(dev):
        err = lib.nm_lj_delta_run(
            pos.data_ptr(), box.data_ptr(), ids.data_ptr(), disp.data_ptr(),
            ln_u.data_ptr(), nbeta.data_ptr(), pe.data_ptr(),
            virial.data_ptr(), acc.data_ptr(), weight.data_ptr(), n, a,
            sig2, rc2, e4, w24, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"B5 run kernel launch failed: CUDA error {err}")
    LAUNCHES["delta"] += 1
    LAUNCHES["delta_attempts"] += a
    return acc, weight


def delta_moves_plain(pot, pos, box, ids, old_r, new_r):
    """The plain PyTorch version of B5: (dE, dW), each (R, M)."""
    _, rc2, _, _ = pot.f32_consts()
    n = pos.shape[1]
    col = torch.arange(n, device=pos.device)
    notself = col[None, None, :] != ids[:, :, None].to(col.dtype)

    def side(r):
        # mover - atom, as the TPU kernel takes it: (R, M, N, 3)
        d = min_image(r[:, :, None, :] - pos[:, None, :, :],
                      box[:, None, None, :])
        r2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] \
            + d[..., 2] * d[..., 2]
        valid = notself & (r2 < rc2)
        e, w = pot.pair_e_w(torch.clamp(r2, min=R2_FLOOR))
        return (torch.where(valid, e, 0.0).sum(dim=-1),
                torch.where(valid, w, 0.0).sum(dim=-1))

    e_new, w_new = side(new_r)
    e_old, w_old = side(old_r)
    return e_new - e_old, w_new - w_old


def position_run_plain(pot, pos, box, ids, disp, ln_u, nbeta, pe, virial):
    """The plain PyTorch version of ``position_run``: ``moves.position``
    once an attempt, dE and dW from ``delta_moves_plain``. Reads the run's
    atom indices on the host."""
    from types import SimpleNamespace

    from neuralmelting_tpu_torch.sampler import moves
    be = moves.brute_backend(plain=True)
    chain = SimpleNamespace(pos=pos, box=box, pe=pe, virial=virial)
    acc = torch.empty(ids.shape[0], dtype=torch.bool, device=pos.device)
    weight = torch.empty(ids.shape[0], dtype=torch.float32,
                         device=pos.device)
    for k, i in enumerate(ids.tolist()):
        acc[k], weight[k] = moves.position(pot, be, chain, nbeta, i, ids[k],
                                           disp[k], ln_u[k])
    return acc, weight
