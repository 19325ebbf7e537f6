"""Test configuration.

The suite runs on the CPU backend with 8 virtual devices (the multi-device
tests build meshes over them); both settings must be in the environment
before JAX initializes a backend.  An explicit ``JAX_PLATFORMS`` wins, so
the tests marked ``gpu`` can run on a card with ``JAX_PLATFORMS=cuda``.

Every test that loads the flagship model gets seeded stand-in weights at
the reference shapes, written as a real caffemodel (so the parser runs)
and installed as the default weights path for the session; oracles read
the same file.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402

SEED = 0


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips on the CPU")


@pytest.fixture(scope="session", autouse=True)
def seeded_caffemodel(tmp_path_factory):
    """Path of the session's seeded caffemodel, also the default path."""
    from reflectance_filtering.models import caffe_io

    path = str(tmp_path_factory.mktemp("weights") / "seeded.caffemodel")
    caffe_io.write_seeded_caffemodel(path, SEED)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(caffe_io, "DEFAULT_CAFFEMODEL", path)
        yield path


@pytest.fixture
def gpu():
    """Skip unless JAX runs on an NVIDIA GPU (decided at run time)."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with JAX_PLATFORMS=cuda)")


@pytest.fixture
def triton_interpret(monkeypatch):
    """Route the product dispatch to the Triton kernels, run by the Pallas
    interpreter on the CPU (what the GPU runs, minus the compiler)."""
    import functools

    from reflectance_filtering.models import networks
    from reflectance_filtering.ops import (bilateral, bilateral_triton,
                                           cnn_triton)

    for mod in (bilateral, networks):
        monkeypatch.setattr(mod, "use_kernels", lambda: True)
    monkeypatch.setattr(bilateral_triton, "bilateral_triton",
                        functools.partial(bilateral_triton.bilateral_triton,
                                          interpret=True))
    monkeypatch.setattr(cnn_triton, "reflectance_cnn_triton",
                        functools.partial(
                            cnn_triton.reflectance_cnn_triton,
                            interpret=True))


@pytest.fixture
def rng():
    return np.random.RandomState(0)
