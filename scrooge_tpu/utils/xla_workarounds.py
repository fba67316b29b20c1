"""XLA workarounds applied at import time (before backend init).

XLA:CPU's LLVM pipeline exhibits a pathological superlinear blowup
(minutes per kernel) compiling this engine's nested while/fori loops over
multi-dim uint32 arrays; ``--xla_llvm_disable_expensive_passes=true``
reduces a ~290s compile to ~4s with no measurable runtime difference.
XLA:GPU lowers through LLVM too, where the flag could cost kernel speed,
so it is set only for processes that will run on the CPU.
"""

import importlib.util
import os

_GPU_PLUGINS = ("jax_cuda12_plugin", "jax_cuda13_plugin", "jax_rocm_plugin")


def _cpu_only() -> bool:
    """Whether this process runs JAX on the CPU: JAX_PLATFORMS names no
    GPU platform or, when it is unset, no GPU plug-in is installed."""
    platforms = os.environ.get("JAX_PLATFORMS", "")
    if platforms:
        return not any(p in platforms for p in ("cuda", "gpu", "rocm"))
    return all(importlib.util.find_spec(m) is None for m in _GPU_PLUGINS)


def apply():
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_llvm_disable_expensive_passes" not in flags and _cpu_only():
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_llvm_disable_expensive_passes=true"
        ).strip()
