"""Test configuration: force an 8-device virtual CPU mesh.

Tests run without GPU hardware (the Pallas kernel in interpret mode);
multi-device sharding is validated on a virtual CPU mesh. Must run before
jax imports. Tests that need the card carry the ``gpu`` marker and skip
here (the ``gpu`` fixture below decides, at run time).
"""

import os

import pytest

# FORCE cpu (not setdefault): a GPU-equipped host would otherwise run the
# suite on the card, without the 8 virtual devices the mesh tests need.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    flags = (flags + " --xla_force_host_platform_device_count=8").strip()
if "xla_llvm_disable_expensive_passes" not in flags:
    # see scrooge_tpu/utils/xla_workarounds.py
    flags = (flags + " --xla_llvm_disable_expensive_passes=true").strip()
os.environ["XLA_FLAGS"] = flags

# persistent compilation cache: engine shapes recompile across test runs
# otherwise (tens of seconds per shape on CPU XLA)
_cache_dir = os.path.join(os.path.dirname(__file__), "..", ".jax_cache")
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", _cache_dir)
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "0")


@pytest.fixture
def gpu():
    """The first JAX device when it is a GPU; skips the test otherwise.
    Decided here, at run time, never while modules are imported."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run: python chip_smoke.py)")
    return dev
