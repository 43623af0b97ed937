"""Kernel B5: brute-force LJ energy and virial changes of trial moves.

Counterpart of the Pallas TPU kernel ``delta_moves_pallas``
(``neuralmelting_tpu/ops/pallas/lj_kernel.py``): for M movers of each of R
replicas, the minimum-image LJ dE = E(new) - E(old) of the mover against
all N atoms of its replica, itself excluded, inside rc, with r^2 floored
at 1e-4. In the same pass it computes dW, the pair-virial change that
``ops/energy.py::delta_move_brute`` returns beside dE and that the serial
engine's records read.

Two forms: the hand-written CUDA kernel (``csrc/lj_delta.cu``) for CUDA
tensors, and ``delta_moves_plain`` for CPU tensors, the tests and
``chip_smoke.py``. No fallback: a CUDA tensor launches the kernel or
raises. ``LAUNCHES["delta"]`` counts kernel launches only.

Shapes: pos (R, N, 3) f32, box (R, 3) f32, ids (R, M) int32, old_r and
new_r (R, M, 3) f32 -> (dE, dW), each (R, M) f32. Each pair term has
``LJCut.pair_e_w``'s f32 operations in both forms, so per pair they agree
bit for bit; the sums over N are taken in different orders.
"""

from __future__ import annotations

import torch

from neuralmelting_tpu_torch.ops.energy import min_image

LAUNCHES = {"delta": 0}
R2_FLOOR = 1e-4


def reset_launches():
    LAUNCHES["delta"] = 0


def delta_moves(pot, pos, box, ids, old_r, new_r):
    """(dE, dW), each (R, M): B5 on a CUDA tensor, the plain version on a
    CPU tensor."""
    if pos.device.type == "cpu":
        return delta_moves_plain(pot, pos, box, ids, old_r, new_r)
    if pos.device.type != "cuda":
        raise ValueError(f"no B5 kernel for device {pos.device}")
    return _delta_cuda(pot, pos, box, ids, old_r, new_r)


def _check(name, t, shape, dtype, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if t.device != device or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous on {device}")


def _delta_cuda(pot, pos, box, ids, old_r, new_r):
    from neuralmelting_tpu_torch.ops import _build
    r, n, _ = pos.shape
    m = ids.shape[1]
    dev = pos.device
    _check("pos", pos, (r, n, 3), torch.float32, dev)
    _check("box", box, (r, 3), torch.float32, dev)
    _check("ids", ids, (r, m), torch.int32, dev)
    _check("old_r", old_r, (r, m, 3), torch.float32, dev)
    _check("new_r", new_r, (r, m, 3), torch.float32, dev)
    out = torch.empty((2, r, m), dtype=torch.float32, device=dev)
    sig2, rc2, e4, w24 = pot.f32_consts()
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.nm_lj_delta(
            pos.data_ptr(), box.data_ptr(), ids.data_ptr(),
            old_r.data_ptr(), new_r.data_ptr(), out.data_ptr(), r, n, m,
            sig2, rc2, e4, w24, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"B5 kernel launch failed: CUDA error {err}")
    LAUNCHES["delta"] += 1
    return out[0], out[1]


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
