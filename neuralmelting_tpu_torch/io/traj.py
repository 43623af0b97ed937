""".traj text format: per-frame header + coordinates.

Counterpart of ``neuralmelting_tpu.io.traj``, byte for byte the JAX
package's writers. ``write`` and ``read`` take the native library
(``io/native``) when it is built, else their Python code (the reference);
the bytes written are the same either way, and the native reader returns
the f32 values the writer printed, as the JAX package's does:

    # nm-traj-1
    <natoms> <box_x> <box_y> <box_z> <sweep>
    <x> <y> <z>          (natoms lines, %.9e)
    ...next frame...
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from neuralmelting_tpu_torch.io import native

MAGIC = "# nm-traj-1"


def _np(v):
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def write(path: str, positions, boxes, sweeps=None, append: bool = False):
    """positions: (nframes, N, 3); boxes: (nframes, 3); arrays or
    tensors."""
    positions, boxes = _np(positions), _np(boxes)
    nframes, natoms, _ = positions.shape
    sweeps = np.zeros((nframes,), np.int64) if sweeps is None \
        else _np(sweeps)
    if native.write_traj(path, positions, boxes, sweeps, append):
        return
    with open(path, "a" if append else "w") as f:
        if not append:
            f.write(MAGIC + "\n")
        for k in range(nframes):
            b = boxes[k]
            f.write(f"{natoms:d} {b[0]:.9e} {b[1]:.9e} {b[2]:.9e} "
                    f"{int(sweeps[k]):d}\n")
            for row in positions[k]:
                f.write(f"{row[0]:.9e} {row[1]:.9e} {row[2]:.9e}\n")


def read(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse a .traj file -> (positions (F,N,3), boxes (F,3), sweeps (F,))."""
    out = native.read_traj(path)
    if out is not None:
        return out
    frames: List[np.ndarray] = []
    boxes: List[np.ndarray] = []
    sweeps: List[int] = []
    with open(path) as f:
        first = f.readline().strip()
        if first != MAGIC:
            raise ValueError(f"{path}: not a {MAGIC} file (got {first!r})")
        while True:
            header = f.readline()
            if not header:
                break
            parts = header.split()
            if not parts:
                continue
            natoms = int(parts[0])
            boxes.append(np.array([float(x) for x in parts[1:4]]))
            sweeps.append(int(parts[4]) if len(parts) > 4 else 0)
            frames.append(np.array([[float(x) for x in f.readline().split()]
                                    for _ in range(natoms)]).reshape(natoms,
                                                                     3))
    if not frames:
        return (np.zeros((0, 0, 3)), np.zeros((0, 3)),
                np.zeros((0,), np.int64))
    return (np.stack(frames), np.stack(boxes),
            np.asarray(sweeps, np.int64))
