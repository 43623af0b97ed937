""".thrm text format: header + one line per record.

Counterpart of ``neuralmelting_tpu.io.thermo``, byte for byte the JAX
package's writers. ``write`` takes the native writer (``io/native``) when
it is built and the Python writer (``write_header`` + ``append_records``,
the reference) otherwise; both give the same bytes:

    # nm-thrm-1
    # <key> <value>            (one per header item, echoing run parameters)
    # columns: sweep temp press pe ke virial vol acc_pos acc_vol acc_hmc ...
    <i> <12 floats in %.9e>
"""

from __future__ import annotations

import io as _io
from typing import Dict, Optional

import numpy as np
import torch

from neuralmelting_tpu_torch.io import native

COLUMNS = ("sweep", "temp", "press", "pe", "ke", "virial", "vol",
           "acc_pos", "acc_vol", "acc_hmc", "dpos", "dvol", "dt")

MAGIC = "# nm-thrm-1"


def _np(v):
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def write_header(f, params: Optional[Dict] = None):
    f.write(MAGIC + "\n")
    for k, v in (params or {}).items():
        f.write(f"# {k} {v}\n")
    f.write("# columns: " + " ".join(COLUMNS) + "\n")


def append_records(f, records):
    """records: mapping column -> (nrec,) array or tensor (or a
    ThermoRecord's fields by name)."""
    cols = [_np(records[c]).reshape(-1) for c in COLUMNS]
    for r in range(cols[0].shape[0]):
        fields = [f"{int(cols[0][r]):d}"]
        fields += [f"{float(c[r]):.9e}" for c in cols[1:]]
        f.write(" ".join(fields) + "\n")


def write(path: str, records, params: Optional[Dict] = None,
          append: bool = False):
    data = np.stack([np.asarray(_np(records[c]), np.float64).reshape(-1)
                     for c in COLUMNS], axis=1)
    hdr = _io.StringIO()
    if not append:
        write_header(hdr, params)
    if native.write_thermo_rows(path, data, hdr.getvalue(), append):
        return
    with open(path, "a" if append else "w") as f:
        if not append:
            write_header(f, params)
        append_records(f, records)


def read(path: str):
    """Parse a .thrm file -> (params dict, dict of column arrays)."""
    params = {}
    rows = []
    with open(path) as f:
        first = f.readline().strip()
        if first != MAGIC:
            raise ValueError(f"{path}: not a {MAGIC} file (got {first!r})")
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith("#"):
                body = line[1:].strip()
                if body.startswith("columns:"):
                    continue
                k, _, v = body.partition(" ")
                params[k] = v
            else:
                rows.append([float(x) for x in line.split()])
    arr = np.asarray(rows, np.float64) if rows \
        else np.zeros((0, len(COLUMNS)))
    data = {c: arr[:, i] for i, c in enumerate(COLUMNS)}
    data["sweep"] = data["sweep"].astype(np.int64)
    return params, data
