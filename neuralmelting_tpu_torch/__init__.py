"""neuralmelting_tpu_torch — the PyTorch/CUDA port of neuralmelting_tpu.

The cellmc production paths of the JAX package (replica-exchange NPT cell
Monte Carlo -> g(r)/S(q) -> extreme-T phase classifier -> T_m fit), LJ and
EAM, in PyTorch, for one NVIDIA Hopper GPU. Module names follow the JAX
package, so each counterpart is easy to find:

* ``pipeline.melting_pipeline`` — the entry point (engine="cellmc").
* ``runner`` — setup, chunked sampling, geometry maintenance.
* ``sampler/`` — state, chunk engines, adaptation, records, tempering.
* ``ops/cellmc.py`` (LJ) and ``ops/cellmc_eam.py`` (EAM) — the
  hand-written CUDA kernels (``csrc/``) that carry every trial move and
  energy pass, each beside its plain PyTorch version.
* ``models/`` — lattice, LJ, the setfl EAM tables and their Chebyshev
  refit; ``config``, ``units`` — run configuration and unit systems.
* ``features/``, ``neural/`` — structure features and the classifier.

Importing the package needs neither CUDA nor ``nvcc``: the kernels are
compiled at their first launch on a CUDA tensor (``ops/_build.py``).
The package imports neither jax nor anything of the JAX package, which
stays the reference.
"""

__version__ = "0.1.0"
