"""neuralmelting_tpu_torch — the PyTorch/CUDA port of neuralmelting_tpu.

The LJ production path of the JAX package (replica-exchange NPT cell
Monte Carlo -> g(r)/S(q) -> extreme-T phase classifier -> T_m fit) in
PyTorch, for one NVIDIA Hopper GPU. Module names follow the JAX package,
so each counterpart is easy to find:

* ``pipeline.melting_pipeline`` — the entry point (engine="cellmc", LJ).
* ``runner`` — setup, chunked sampling, geometry maintenance.
* ``sampler/`` — state, chunk engine, adaptation, records, tempering.
* ``ops/cellmc.py`` — the two hand-written CUDA kernels (``csrc/``) that
  carry every trial move, each beside its plain PyTorch version.
* ``features/``, ``neural/`` — structure features and the classifier.

Importing the package needs neither CUDA nor ``nvcc``: the kernels are
compiled at their first launch on a CUDA tensor (``ops/_build.py``).
The package never imports jax; the JAX package stays the reference.
"""

__version__ = "0.1.0"
