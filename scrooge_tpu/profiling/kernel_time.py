"""Engine-only timing on the GPU, like the reference times its kernel.

The reference's sweep metric is the core kernel section
(genasm_kernel<<<>>> with one sync, genasm_gpu.cu:939-951 /
scripts/profile.py:55-63). The api's ``core_ns`` is pipeline accounting —
on the predicted-cap fast path it spans engine AND compaction dispatch up
to the single fused meta readback. This module stages a batch on the card
once and times ONLY engine invocations: the Pallas window kernel, or
engine_xla on the same pairs, steady state (compilation excluded), each
call ended by ``block_until_ready``.

A GPU is required: without one these functions raise instead of timing
the CPU under a device metric's name.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np


class Staged(NamedTuple):
    cfg: object
    max_windows: int
    kernel_args: tuple  # packed genome, starts, tlen, packed reads, plen
    xla_args: tuple     # uint8 genome, starts, tlen, uint8 reads, plen
    num_pairs: int


def require_gpu():
    """The device JAX runs on; raises when it is not a GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"engine timing needs a GPU; JAX found {dev.platform!r}")
    return dev


def stage_mapped(genome_content: str, reads, cfg) -> Staged:
    """Stage the first cfg.batch_tile read-mapping pairs on the GPU in
    both engines' input layouts. reads: datamodel.Read list, each with
    exactly one candidate location."""
    import jax

    from .. import native
    from ..api import _bucket_lin, encode_np
    from ..ops import engine_pallas

    require_gpu()
    reads = reads[: cfg.batch_tile]
    if not reads or any(len(r.locations) != 1 for r in reads):
        raise ValueError("stage_mapped needs single-location reads")
    B = _bucket_lin(len(reads), 128)
    glen = len(genome_content)
    longest = max(len(r.content) for r in reads)
    P = _bucket_lin(longest, 1024)
    codes = np.zeros((B, P), np.uint8)
    for lane, r in enumerate(reads):
        q = encode_np(r.content)
        codes[lane, : len(q)] = q
    gpad = _bucket_lin(glen, 1 << 22)
    gcodes = np.zeros(gpad, np.uint8)
    gcodes[:glen] = encode_np(genome_content)
    gwords = native.encode_pack_strs([genome_content], gpad)
    gwords = (gwords[0] if gwords is not None
              else engine_pallas.pack_2bit_host(gcodes[None, :])[0])
    starts = np.zeros(B, np.uint32)
    starts[: len(reads)] = [r.locations[0].start_in_reference for r in reads]
    maxw = -(-cfg.max_windows(longest) // 32) * 32  # same bound as api
    tlen = np.zeros(B, np.int32)
    tlen[: len(reads)] = np.minimum(
        glen - starts[: len(reads)].astype(np.int64),
        maxw * cfg.tb_limit + cfg.W)
    plen = np.zeros(B, np.int32)
    plen[: len(reads)] = [len(r.content) for r in reads]
    put = jax.device_put
    kernel_args = tuple(put(x) for x in (
        gwords, starts, tlen, engine_pallas.pack_2bit_host(codes), plen))
    xla_args = tuple(put(x) for x in (gcodes, starts, tlen, codes, plen))
    jax.block_until_ready((kernel_args, xla_args))
    return Staged(cfg, maxw, kernel_args, xla_args, len(reads))


def run_engine(staged: Staged, engine: str):
    """One engine call on the staged pairs ("pallas" or "xla")."""
    from ..ops import engine_pallas, engine_xla

    if engine == "pallas":
        return engine_pallas.align_batch_mapped(
            staged.cfg, staged.max_windows, *staged.kernel_args)
    return engine_xla.align_batch_mapped(
        staged.cfg, staged.max_windows, *staged.xla_args)


def engine_seconds(staged: Staged, engine: str, reps: int = 3):
    """Per-call wall seconds of `reps` steady-state engine calls (the
    first, compiling call is excluded), each ended by
    block_until_ready."""
    import jax

    require_gpu()
    jax.block_until_ready(run_engine(staged, engine))  # compile + warm
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(run_engine(staged, engine))
        times.append(time.perf_counter() - t0)
    return times


def kernel_rate(staged: Staged, reps: int = 3) -> float:
    """Median engine-only aligns/second of the kernel."""
    return staged.num_pairs / float(
        np.median(engine_seconds(staged, "pallas", reps)))
