"""neuralmelting_tpu_torch — the PyTorch/CUDA port of neuralmelting_tpu.

The production paths of the JAX package (replica-exchange NPT Monte Carlo
-> g(r)/S(q) -> extreme-T phase classifier -> T_m fit), LJ and EAM, in
PyTorch, for one NVIDIA Hopper GPU. Module names follow the JAX package,
so each counterpart is easy to find:

* ``pipeline.melting_pipeline`` — the entry point; its default engine is
  "gather", as in the JAX package, and "cellmc" is the other.
* ``runner`` — setup, chunked sampling, geometry maintenance.
* ``parallel/ensemble.py``, ``sampler/checkerboard.py`` and
  ``ops/neighbors.py`` (LJ), ``ops/eam_energy.py`` (EAM) — the gather
  engine, for LJ and EAM: checkerboard passes over neighbour lists in
  torch operations, replayed from CUDA graphs on the card, where a pass's
  colour substeps run through ``torch.compile``; it launches no
  hand-written kernel.
* ``sampler/`` — state, chunk engines, adaptation, records, tempering.
* ``ops/cellmc.py`` (LJ) and ``ops/cellmc_eam.py`` (EAM) — the
  hand-written CUDA kernels (``csrc/``) of the cellmc engine, which carry
  its every trial move and energy pass, each beside its plain PyTorch
  version.
* ``models/`` — lattice, LJ, the setfl EAM tables and their Chebyshev
  refit; ``config``, ``units`` — run configuration and unit systems.
* ``features/``, ``neural/`` — structure features and the classifier.

Importing the package needs neither CUDA nor ``nvcc``: the kernels are
compiled at their first launch on a CUDA tensor (``ops/_build.py``).
The package imports neither jax nor anything of the JAX package, which
stays the reference.
"""

__version__ = "0.1.0"
