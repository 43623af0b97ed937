"""Run configuration: ``RunConfig``, ``ELEMENTS`` and ``grids`` of the JAX
package (a dataclass module that imports no jax), re-exported so that
users of the port import from the port."""

from neuralmelting_tpu.config import ELEMENTS, RunConfig, grids  # noqa: F401
