"""Parallel-tempering replica exchange (counterpart of
``neuralmelting_tpu.sampler.tempering``).

Configurations stay put and the (T, P) slot identities move:
``slot_of`` (R,) int32 maps replica -> grid slot, and an exchange event
permutes slots between neighbour pairs of the (P, T) grid with the NPT
tempering weight

    ln A = (beta_i - beta_j)(E_i - E_j) + p2e (beta_i P_i - beta_j P_j)(V_i - V_j).

Pairing alternates even/odd along T, then along P. The uniforms ``u`` are
an argument, drawn by the caller (the run's ``torch.Generator``); the
tests feed JAX's own uniforms to hold the port against the reference.
"""

from __future__ import annotations

import torch

from neuralmelting_tpu_torch.sampler.state import box_volume

SLOT_FIELDS = ("dpos", "dvol", "dt", "nap", "ntp", "nav", "ntv", "nah",
               "nth")


def _pair_partner(length: int, phase: int, device):
    """partner[t] for even/odd pairing: (phase, phase+1), (phase+2, ...)."""
    t = torch.arange(length, device=device)
    left = (t % 2 == phase % 2) & (t + 1 < length)
    right = (t % 2 == (phase + 1) % 2) & (t - 1 >= 0)
    return torch.where(left, t + 1, torch.where(right, t - 1, t))


def propose_swaps(e_slot, v_slot, t_slot, p_slot, npress, ntemp,
                  axis: int, phase: int, u, kb: float, p2e: float):
    """One exchange event on the slot grid.

    e_slot, v_slot, t_slot, p_slot: (R,) per grid slot (slot order).
    axis: 1 pairs along T (within a pressure), 0 along P. phase: 0/1.
    u: R uniforms in (0, 1], laid out on the paired grid: (npress, ntemp)
    for axis 1, (ntemp, npress) for axis 0 (JAX draws them with that
    shape); one per unordered pair is used, the left member's.
    Returns (sigma (R,) slot permutation — slot s takes the state of slot
    sigma[s] —, n_acc () accepted swaps).
    """
    shape = (npress, ntemp)
    dev = e_slot.device

    def grid(x):
        g = x.reshape(shape)
        return g.T if axis == 0 else g

    def ungrid(g):
        g = g.T if axis == 0 else g
        return g.reshape(-1)

    e = grid(e_slot)
    v = grid(v_slot)
    beta = 1.0 / (kb * grid(t_slot))
    betap = beta * grid(p_slot) * p2e

    length = e.shape[1]
    partner = _pair_partner(length, phase, dev)
    ln_acc = ((beta - beta[:, partner]) * (e - e[:, partner])
              + (betap - betap[:, partner]) * (v - v[:, partner]))

    t_idx = torch.arange(length, device=dev)
    is_left = (t_idx % 2 == phase % 2) & (t_idx + 1 < length)
    u = u.reshape(e.shape)
    u_pair = torch.where(is_left[None, :], u, u[:, partner])
    swap = (torch.log(u_pair) < ln_acc) & (partner != t_idx)[None, :]
    sigma_col = torch.where(swap, partner[None, :], t_idx[None, :])
    rows = torch.arange(e.shape[0], device=dev)[:, None].expand(e.shape)
    flat = grid(torch.arange(npress * ntemp, device=dev))
    sigma = ungrid(flat[rows, sigma_col])
    n_acc = torch.sum(swap & is_left[None, :])
    return sigma, n_acc


def apply_exchange(states, slot_of, sigma, t_grid, p_grid):
    """Permute slot ownership; re-scatter the slot-attached fields (temp,
    press, step sizes, window counters) to the replicas that now own the
    slots."""
    r = slot_of.shape[0]
    dev = slot_of.device
    perm = torch.argsort(slot_of)        # slot -> replica (old)
    new_perm = perm[sigma]               # slot -> replica (new)
    slot_ids = torch.arange(r, dtype=torch.int32, device=dev)
    new_slot_of = torch.zeros((r,), dtype=torch.int32,
                              device=dev).scatter(0, new_perm, slot_ids)

    def to_new_owner(values_slot):
        return torch.zeros_like(values_slot).scatter(0, new_perm,
                                                     values_slot)

    updates = dict(temp=to_new_owner(t_grid.to(torch.float32)),
                   press=to_new_owner(p_grid.to(torch.float32)))
    for f in SLOT_FIELDS:
        updates[f] = to_new_owner(getattr(states, f)[perm])
    return states.replace(**updates), new_slot_of


def exchange_event(states, slot_of, u, event_idx: int, npress, ntemp,
                   t_grid, p_grid, kb, p2e):
    """Full exchange: cycles phases [T0, T1, P0, P1] by the host-side
    ``event_idx``; ``u`` as in ``propose_swaps``."""
    perm = torch.argsort(slot_of)
    e_slot = states.pe[perm]
    v_slot = box_volume(states.box)[perm]
    branch = event_idx % (4 if npress > 1 else 2)
    axis, phase = ((1, 0), (1, 1), (0, 0), (0, 1))[branch]
    sigma, n_acc = propose_swaps(e_slot, v_slot, t_grid, p_grid, npress,
                                 ntemp, axis, phase, u, kb, p2e)
    states, slot_of = apply_exchange(states, slot_of, sigma, t_grid, p_grid)
    return states, slot_of, n_acc
