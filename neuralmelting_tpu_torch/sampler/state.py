"""Per-replica Monte Carlo state of a replica ensemble.

Counterpart of ``neuralmelting_tpu.sampler.state``: the same fields as
``MCState``, here a dataclass of tensors that all carry a leading replica
axis R. Where the JAX engine donates a buffer, the port updates in place
or replaces the tensor. The per-replica jax PRNG ``key`` field is dropped:
the cellmc path never reads it (its host draws come from one
``torch.Generator`` per run, see sampler/cellmc.py).

CONTRACT (as in the JAX package): ``pe`` and ``virial`` are exact at
every record point; between records the cellmc engine carries an
f32-accumulated pe and a virial pinned to its last record / pre-rescale
value. Read thermodynamics from records.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

FIELDS = ("pos", "box", "pe", "virial", "temp", "press", "dpos", "dvol",
          "dt", "nap", "ntp", "nav", "ntv", "nah", "nth", "sweep")


@dataclasses.dataclass
class MCState:
    pos: torch.Tensor       # (R, N, 3) f32
    box: torch.Tensor       # (R, 3) edge lengths
    pe: torch.Tensor        # (R,) potential energy
    virial: torch.Tensor    # (R,) scalar pair virial sum r*f
    temp: torch.Tensor      # (R,) slot temperature
    press: torch.Tensor     # (R,) slot pressure
    dpos: torch.Tensor      # (R,) max displacement per axis
    dvol: torch.Tensor      # (R,) max absolute volume change
    dt: torch.Tensor        # (R,) HMC timestep (carried, unused by cellmc)
    nap: torch.Tensor       # (R,) i32 accepted position moves
    ntp: torch.Tensor       # (R,) i32 tried position moves
    nav: torch.Tensor       # (R,) i32 accepted volume moves
    ntv: torch.Tensor       # (R,) i32 tried volume moves
    nah: torch.Tensor       # (R,) i32 accepted HMC moves
    nth: torch.Tensor       # (R,) i32 tried HMC moves
    sweep: torch.Tensor     # (R,) i32 sweeps completed

    def replace(self, **kw) -> "MCState":
        return dataclasses.replace(self, **kw)

    def clone(self) -> "MCState":
        return MCState(**{f: getattr(self, f).clone() for f in FIELDS})


def box_volume(box):
    """Lx Ly Lz, multiplied in that order."""
    return box[..., 0] * box[..., 1] * box[..., 2]


def ensemble_init(pos, box, temps, presses, dpos0, dvol_frac0, dt0,
                  device="cpu") -> MCState:
    """A replica ensemble on ``device``: the same lattice for every
    (temp, press) pair of the flat (R,) grids. pe and virial start at 0;
    the cellmc engine refreshes them from the slabs (refresh_energies).
    ``dvol_frac0`` is the initial max volume step as a fraction of V0."""
    temps = torch.as_tensor(temps, dtype=torch.float32,
                            device=device).clone()
    presses = torch.as_tensor(presses, dtype=torch.float32,
                              device=device).clone()
    r = temps.shape[0]
    pos = torch.as_tensor(np.asarray(pos), dtype=torch.float32,
                          device=device)
    box = torch.as_tensor(np.asarray(box), dtype=torch.float32,
                          device=device)
    vol0 = box_volume(box)

    def full(v):
        return torch.full((r,), v, dtype=torch.float32, device=device)

    def zeros_i():
        return torch.zeros((r,), dtype=torch.int32, device=device)

    return MCState(
        pos=pos[None].repeat(r, 1, 1), box=box[None].repeat(r, 1),
        pe=full(0.0), virial=full(0.0), temp=temps, press=presses,
        dpos=full(dpos0),
        dvol=full(dvol_frac0) * vol0, dt=full(dt0),
        nap=zeros_i(), ntp=zeros_i(), nav=zeros_i(), ntv=zeros_i(),
        nah=zeros_i(), nth=zeros_i(), sweep=zeros_i())


def state_from_numpy(arrays: dict, device="cpu"):
    """Carry ensemble state over from the JAX package.

    ``arrays`` maps names to numpy arrays with a leading R axis, e.g. the
    fields of a JAX ``MCState`` (``key`` is ignored) and slab arrays
    (``x``, ``y``, ``z``, ``ids``, ``count``). Returns (state, rest):
    an ``MCState`` when every state field is present (else None), and a
    dict of the remaining arrays as tensors on ``device`` (float arrays as
    f32, integer arrays as int32).
    """
    def conv(a):
        a = np.array(a)
        dt = torch.int32 if np.issubdtype(a.dtype, np.integer) \
            else torch.float32
        return torch.as_tensor(a, dtype=dt, device=device)

    tensors = {k: conv(v) for k, v in arrays.items() if k != "key"}
    state = None
    if all(f in tensors for f in FIELDS):
        state = MCState(**{f: tensors.pop(f) for f in FIELDS})
    return state, tensors
