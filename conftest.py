"""Repository-wide pytest hook: build the native text-IO library once.

Under pytest-xdist every worker imports every test file, and
``tests/test_native_io.py`` asks ``neuralmelting_tpu.io.native`` for its
library while it is imported. Where the library is not built yet, each
worker would compile it at once through one shared temporary file, and a
worker whose build loses that race skips the file's tests. The
controller (or a run without workers) builds it here, before any worker
starts; the workers then find it newer than its source and only load it.

The module is loaded by its path, so neither jax nor the package's
``__init__`` is imported here.
"""

import importlib.util
import os

NATIVE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "neuralmelting_tpu", "io", "native", "__init__.py")


def pytest_configure(config):
    if hasattr(config, "workerinput"):
        return
    spec = importlib.util.spec_from_file_location("_nm_native_build", NATIVE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.get_lib()
