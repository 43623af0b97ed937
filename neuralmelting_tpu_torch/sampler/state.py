"""Per-replica Monte Carlo state.

Counterpart of ``neuralmelting_tpu.sampler.state``: the same fields as
``MCState``, here a dataclass of tensors. An ensemble (the cellmc engine)
carries a leading replica axis R on every field; one serial chain
(``init_state``, ``sampler/serial.py``) has none, as in the JAX package.
Where the JAX engine donates a buffer, the port updates in place or
replaces the tensor.

``key`` is the chain's ``jax.random`` key as two uint32 words held in
int64 (``ops/jrandom.py``), (2,) for a serial chain, on the host: the
serial engine derives every draw of a sweep from it before the sweep's
moves. The cellmc path leaves it ``None``: its host draws come from one
``torch.Generator`` per run (sampler/cellmc.py).

CONTRACT (as in the JAX package): ``pe`` and ``virial`` are exact at
every record point; between records the cellmc engine carries an
f32-accumulated pe and a virial pinned to its last record / pre-rescale
value. Read thermodynamics from records.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from neuralmelting_tpu_torch.ops import energy, jrandom

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
    key: Optional[torch.Tensor] = None  # (2,) jax.random key words (serial)

    def replace(self, **kw) -> "MCState":
        return dataclasses.replace(self, **kw)

    def clone(self) -> "MCState":
        key = None if self.key is None else self.key.clone()
        return MCState(**{f: getattr(self, f).clone() for f in FIELDS},
                       key=key)


def box_volume(box):
    """Lx Ly Lz, multiplied in that order."""
    return box[..., 0] * box[..., 1] * box[..., 2]


def init_state(pot, pos, box, key, temp, press, dpos0, dvol_frac0, dt0,
               device="cuda") -> MCState:
    """One serial chain on ``device`` (the card unless asked otherwise),
    with exact pe and virial from ``ops/energy.py::pair_energy_virial``.
    ``key`` is a ``jax.random`` key (``ops/jrandom.py``, kept on the
    host); ``dvol_frac0`` is the initial max volume step as a fraction of
    V0 (the stored ``dvol`` is absolute)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_state runs on the card (CUDA) by default, "
                           "and no CUDA device is available; pass "
                           "device=\"cpu\" to run on the CPU")
    pos = torch.as_tensor(np.asarray(pos), dtype=torch.float32,
                          device=device)
    box = torch.as_tensor(np.asarray(box), dtype=torch.float32,
                          device=device)
    pe, vir = energy.pair_energy_virial(pot, pos, box)

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    def i0():
        return torch.zeros((), dtype=torch.int32, device=device)

    return MCState(
        pos=pos, box=box, pe=pe, virial=vir, temp=f32(temp),
        press=f32(press), dpos=f32(dpos0),
        dvol=f32(dvol_frac0) * box_volume(box), dt=f32(dt0),
        nap=i0(), ntp=i0(), nav=i0(), ntv=i0(), nah=i0(), nth=i0(),
        sweep=i0(), key=jrandom.key_data(key).cpu().clone())


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
    """Carry state over from the JAX package.

    ``arrays`` maps names to numpy arrays, e.g. the fields of a JAX
    ``MCState`` (an ensemble's with a leading R axis, or one serial
    chain's) and slab arrays (``x``, ``y``, ``z``, ``ids``, ``count``).
    A ``key`` entry is the chain's key as ``jax.random.key_data`` gives
    it, uint32 (..., 2); it becomes the state's ``key`` words, on the host.
    Returns (state, rest): an ``MCState`` when every state field is
    present (else None), and a dict of the remaining arrays as tensors on
    ``device`` (float arrays as f32, integer arrays as int32).
    """
    def conv(a):
        a = np.array(a)
        dt = torch.int32 if np.issubdtype(a.dtype, np.integer) \
            else torch.float32
        return torch.as_tensor(a, dtype=dt, device=device)

    key = arrays.get("key")
    tensors = {k: conv(v) for k, v in arrays.items() if k != "key"}
    state = None
    if all(f in tensors for f in FIELDS):
        state = MCState(**{f: tensors.pop(f) for f in FIELDS},
                        key=None if key is None else jrandom.key_data(key))
    return state, tensors
