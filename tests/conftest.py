"""Test configuration: force an 8-virtual-device CPU JAX platform.

Multi-device sharding logic is exercised on a virtual CPU mesh; the
Pallas kernel runs in interpret mode on the CPU (the platform seam,
kernels.kernel_interpret).  Must be set before jax is imported anywhere.
The platform is the CPU whatever JAX_PLATFORMS holds, unless
OSWALD_TEST_GPU=1 asks for the card.  Tests that need the GPU carry the
`gpu` marker and take the `gpu` fixture, which skips them on the CPU.  On
a machine with a card: `OSWALD_TEST_GPU=1 python -m pytest tests -m gpu`
(the oracle runs on the CPU backend).
"""

import os

PLATFORMS = "cuda,cpu" if os.environ.get("OSWALD_TEST_GPU") == "1" else "cpu"
os.environ["JAX_PLATFORMS"] = PLATFORMS
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", PLATFORMS)

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """The first JAX device when it is a GPU; skips the test otherwise.
    Decided here, at run time, never at import (every xdist worker must
    collect the same tests)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX platform {dev.platform!r}); run "
                    f"`OSWALD_TEST_GPU=1 python -m pytest tests -m gpu` on "
                    f"a card")
    return dev


def random_protein(rng, n):
    """Random encoded protein sequence (codes 0..22)."""
    return rng.integers(0, 23, size=n, dtype=np.int8)
