"""One pair of host backends for the tests that compare the port's host
arrays with the JAX package's exactly.

Both packages carry a compiled host helper (g++, `native/geometry.cpp`)
with a numpy fallback, and the two backends of one package do not give the
same arrays (the synthetic frames' boxes, the kNN tie order). The JAX
package builds its helper in place into a directory that every test worker
shares (`RADARGNN_NATIVE_CACHE`, by default under the system's temporary
directory), and a worker that fails to load it stays on numpy for good; the
port builds into its own directory by an atomic rename. A worker could so
compare the JAX package's numpy arrays with the port's compiled ones.

`host_pair` gives the JAX package a build directory of this worker's own and
loads both helpers; where either cannot load, it puts both packages on
numpy. Either way the two packages run the same backend, and the backends'
state is restored after the test. Import the fixtures into a test module to
use them:

    from host_backends import host_pair, native_cache  # noqa: F401
"""

import pytest

import radargnn_tpu.native as jax_native
import radargnn_tpu_torch.native as port_native

MODULES = {"JAX package": jax_native, "port": port_native}


def pin(setattr_, native: bool = True) -> str:
    """Puts both packages on one backend and returns it: "native" where
    `native` is asked for and both compiled helpers load, else "numpy".
    `setattr_` sets the module attributes (`monkeypatch.setattr`, so that
    they are restored)."""
    if native:
        for mod in MODULES.values():
            setattr_(mod, "_LIB", None)
            setattr_(mod, "_TRIED", False)
        if all(mod.load() is not None for mod in MODULES.values()):
            return "native"
    for mod in MODULES.values():
        setattr_(mod, "_LIB", None)
        setattr_(mod, "_TRIED", True)
    return "numpy"


def backends() -> dict:
    """The backend each package runs now: "native", "numpy", or "unset"
    where it has not tried to load its helper yet."""
    return {name: "native" if mod._LIB is not None
            else "numpy" if mod._TRIED else "unset"
            for name, mod in MODULES.items()}


_BUILD_DIR = {}


@pytest.fixture(scope="module")
def native_cache(tmp_path_factory):
    """A build directory for the JAX package's helper, this worker's own
    (made once per process)."""
    if "dir" not in _BUILD_DIR:
        _BUILD_DIR["dir"] = tmp_path_factory.mktemp("radargnn_native")
    return _BUILD_DIR["dir"]


@pytest.fixture
def host_pair(monkeypatch, native_cache) -> str:
    """Both packages on their compiled helpers, or both on numpy; returns
    which ("native" or "numpy")."""
    monkeypatch.setenv("RADARGNN_NATIVE_CACHE", str(native_cache))
    return pin(monkeypatch.setattr)
