"""Ensemble checkpoint and restart (counterpart of
``neuralmelting_tpu.io.checkpoint``), in the JAX package's npz layout.

One uncompressed ``.npz`` holds every ``MCState`` field (f32 tensors,
int32 counters and ``sweep``), ``key_data`` (R, 2) uint32, ``slot_of``
int32, ``config`` (the ``RunConfig`` JSON as bytes) and each extra entry
as ``x_<name>``. The JAX package's ``checkpoint.load`` reads a port
checkpoint and this ``load`` reads a JAX one.

``key_data`` holds the replicas' live keys where the ensemble carries
them (the gather engine, ``sampler/state.py``), so a resumed run goes on
with its own draws. A cellmc ensemble carries none (its host draws come
from a key chain of the config's seed and the sweep counter, which a
resumed run rederives on any device): for it ``save`` writes the keys
the JAX ``ensemble_init`` derives, ``fold_in(key(seed), r)`` for replica
r (``ops/jrandom.py``), with the seed read from the config. ``load``
restores ``key_data`` as the states' keys, on ``device``. What the port's
runner needs besides for an exact resume travels as extras
(``runner.checkpoint_extras``). Earlier port checkpoints also held a
``torch.Generator`` state (``x_gen_state``, ``x_gen_device``): ``load``
drops it with one warning.
"""

from __future__ import annotations

import json
import warnings

import numpy as np
import torch

from neuralmelting_tpu_torch.ops import jrandom
from neuralmelting_tpu_torch.sampler.state import FIELDS, MCState

_INT_FIELDS = ("nap", "ntp", "nav", "ntv", "nah", "nth", "sweep")
_GEN_EXTRAS = {"gen_state", "gen_device"}


def ensemble_key_data(seed: int, r: int) -> np.ndarray:
    """(r, 2) uint32: the JAX ensemble's replica keys for ``seed``."""
    keys = jrandom.fold_in(jrandom.key(seed), torch.arange(r))
    return keys.numpy().astype(np.uint32)


def _host(v):
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def save(path: str, states: MCState, slot_of, config_json: str = "{}",
         extra: dict = None):
    """Write ``states`` (an ensemble, leading R), ``slot_of``, the config
    and the extras; ``key_data`` the states' keys, or without keys those
    the config's ``seed`` derives (0 without one)."""
    arrays = {}
    for f in FIELDS:
        dt = np.int32 if f in _INT_FIELDS else np.float32
        arrays[f] = _host(getattr(states, f)).astype(dt)
    if states.key is not None:
        arrays["key_data"] = _host(states.key).astype(np.uint32)
    else:
        seed = json.loads(config_json).get("seed", 0)
        arrays["key_data"] = ensemble_key_data(seed, states.temp.shape[0])
    arrays["slot_of"] = _host(slot_of).astype(np.int32)
    for k, v in (extra or {}).items():
        arrays["x_" + k] = _host(v)
    np.savez(path, config=np.frombuffer(config_json.encode(), np.uint8),
             **arrays)


def load(path: str, device="cpu"):
    """Returns (states, slot_of, config_json, extra): ``states`` (their
    ``key`` the (R, 2) ``key_data`` words) and ``slot_of`` as tensors on
    ``device`` (f32 fields, int32 counters), ``extra`` the ``x_`` entries
    as numpy arrays."""
    with np.load(path) as z:
        def t(name, dt):
            return torch.as_tensor(np.asarray(z[name]), dtype=dt,
                                   device=device)

        states = MCState(**{f: t(f, torch.int32 if f in _INT_FIELDS
                                 else torch.float32) for f in FIELDS},
                         key=jrandom.key_data(z["key_data"]).to(device))
        slot_of = t("slot_of", torch.int32)
        config_json = bytes(z["config"]).decode() if "config" in z \
            else "{}"
        extra = {k[2:]: z[k] for k in z.files
                 if k.startswith("x_") and k[2:] not in _GEN_EXTRAS}
        if _GEN_EXTRAS & {k[2:] for k in z.files}:
            warnings.warn(f"checkpoint {path} holds a torch.Generator "
                          "state, which the port no longer uses: the "
                          "cellmc host draws go on from the config's seed "
                          "and the sweep counter", RuntimeWarning,
                          stacklevel=2)
    return states, slot_of, config_json, extra
