"""Build the JAX package's native libraries once, before any test worker.

``ganon_tpu/native`` compiles its g++ libraries lazily, each into one
``.so.tmp`` path shared by every process. Under pytest-xdist every worker
collects ``tests/test_native.py``, whose module-level ``skipif`` asks
``NativeSeqReader.available()``: the workers then compile into the same
temporary file at once, and a worker whose ``os.replace`` loses the race
reports the library as unavailable and skips the module's tests. Building
both libraries here, in the controller process before the workers start,
leaves every worker an existing library to load.

The module is loaded by file path, so ``ganon_tpu/__init__.py`` (and its
jax import) does not run in the controller.
"""

import importlib.util
import os

_NATIVE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "ganon_tpu", "native")


def pytest_configure(config):
    if hasattr(config, "workerinput"):  # an xdist worker: the controller built
        return
    spec = importlib.util.spec_from_file_location(
        "_ganon_tpu_native_prebuild", os.path.join(_NATIVE, "__init__.py"))
    native = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(native)
    native._build_lib()
    native._compile(os.path.join(_NATIVE, "lca.cpp"), "lca")
