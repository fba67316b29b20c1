"""Multi-chip scaling: data parallelism over alignment pairs on a mesh.

The reference has no distributed backend at all — one process, one GPU
(genasm_gpu.cu:67), OpenMP threads on CPU (genasm_cpu.cpp:440-460). Here
both concurrency axes become SPMD over a 1-D ``jax.sharding.Mesh``:

 - axis ``pairs``: alignment pairs are embarrassingly parallel, so the
   batch dimension is sharded across every device (the analogue of
   OpenMP's dynamic pair scheduling and the GPU's persistent-block work
   queue — load balance comes from length-sorted batching instead of
   work stealing, cf. tests.cu:375-377).
 - the reference genome is *replicated* to every device (a packed human
   genome is ~0.75 GiB — comfortably within device memory), so window
   reads are device-local and the kernel path needs **zero
   collectives**; the XLA engine's only cross-device traffic is its
   batched early-termination reduction and result gathering.

The mesh is 1-D because every card of a host reaches every other at the
same rate; nothing here assumes a topology. Works identically on GPU
meshes and on the virtual CPU mesh used in tests
(XLA_FLAGS=--xla_force_host_platform_device_count=N).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import AlignConfig
from ..ops import engine_xla

shard_map = jax.shard_map

PAIR_AXIS = "pairs"


def make_mesh(num_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over all (or the first ``num_devices``) local devices.

    LOCAL devices deliberately: in a multi-process (jax.distributed) run
    each process feeds its own host-local batch shard (parallel/
    distributed.py owns the cross-process split), so a mesh spanning
    other processes' non-addressable devices could never receive the
    device_puts the tile loops perform."""
    if devices is None:
        devices = jax.local_devices()
    if num_devices is not None:
        if num_devices > len(devices):
            raise ValueError(
                f"requested {num_devices} devices, have {len(devices)}")
        devices = devices[:num_devices]
    return Mesh(np.asarray(devices), (PAIR_AXIS,))


def pair_sharding(mesh: Mesh, batch_dim: int = 0, ndim: int = 1) -> NamedSharding:
    """Shard dimension ``batch_dim`` of an ndim-rank array over pairs."""
    spec = [None] * ndim
    spec[batch_dim] = PAIR_AXIS
    return NamedSharding(mesh, P(*spec))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def _check_batch(B: int, mesh: Mesh):
    n = mesh.devices.size
    if B % (128 * n) != 0:
        raise ValueError(
            f"batch {B} must be a multiple of 128 lanes x {n} devices")


def align_batch_on_mesh(cfg: AlignConfig, max_windows: int, mesh: Mesh,
                        text, text_len, pattern, pattern_len):
    """Sharded unstructured alignment: every input batch-sharded over pairs.

    Placement-driven: inputs are device_put with pair shardings and the
    jitted engine compiles an SPMD program around them. Per-pair work is
    chip-local; XLA inserts only the ET all-reduce.
    """
    _check_batch(pattern.shape[0], mesh)
    sh2 = pair_sharding(mesh, 0, 2)
    sh1 = pair_sharding(mesh, 0, 1)
    text = jax.device_put(text, sh2)
    text_len = jax.device_put(text_len, sh1)
    pattern = jax.device_put(pattern, sh2)
    pattern_len = jax.device_put(pattern_len, sh1)
    with mesh:
        return engine_xla.align_batch(
            cfg, max_windows, text, text_len, pattern, pattern_len)


def align_batch_mapped_on_mesh(cfg: AlignConfig, max_windows: int, mesh: Mesh,
                               genome, starts, text_len,
                               pattern, pattern_len):
    """Sharded read-mapping alignment: genome replicated, pairs sharded."""
    _check_batch(pattern.shape[0], mesh)
    sh2 = pair_sharding(mesh, 0, 2)
    sh1 = pair_sharding(mesh, 0, 1)
    genome = jax.device_put(genome, replicated(mesh))
    starts = jax.device_put(starts, sh1)
    text_len = jax.device_put(text_len, sh1)
    pattern = jax.device_put(pattern, sh2)
    pattern_len = jax.device_put(pattern_len, sh1)
    with mesh:
        return engine_xla.align_batch_mapped(
            cfg, max_windows, genome, starts, text_len, pattern, pattern_len)


# ---------------------------------------------------------------------------
# The window kernel on the mesh (the performance path).
#
# The kernel is a custom call XLA cannot auto-partition, so the mesh
# integration is shard_map over the pairs axis: each device runs the
# kernel on its local pairs. The kernel's only cross-lane operations
# (per-warp early termination) stay inside a block, and the compaction's
# cap arithmetic becomes SHARD-LOCAL under shard_map, so the steady state
# needs ZERO collectives (test_parallel.py asserts the compiled HLO has
# none). This is the dispatch role of the reference GPU's persistent-block
# work queue (genasm_gpu.cu:583-629): static sharding + length-sorted
# batching replaces device-side work stealing.
# ---------------------------------------------------------------------------

_RESULT_SPECS = engine_xla.BatchResult(
    edit_distance=P(PAIR_AXIS),
    failed=P(PAIR_AXIS),
    entries=P(None, None, PAIR_AXIS),
    counts=P(None, PAIR_AXIS),
)


@functools.lru_cache(maxsize=64)
def _pallas_sharded_fn(cfg: AlignConfig, max_windows: int, mesh: Mesh,
                       mapped: bool):
    from ..ops import engine_pallas

    if mapped:
        in_specs = (P(), P(PAIR_AXIS), P(PAIR_AXIS),
                    P(PAIR_AXIS, None), P(PAIR_AXIS))

        def fn(genome, starts, text_len, pattern, pattern_len):
            return engine_pallas.align_batch_mapped(
                cfg, max_windows, genome, starts, text_len,
                pattern, pattern_len)
    else:
        in_specs = (P(PAIR_AXIS, None), P(PAIR_AXIS),
                    P(PAIR_AXIS, None), P(PAIR_AXIS))

        def fn(text, text_len, pattern, pattern_len):
            return engine_pallas.align_batch(
                cfg, max_windows, text, text_len, pattern, pattern_len)

    # check_vma=False: pallas_call outputs carry no varying-mesh-axes
    # metadata, and the engine is purely per-lane anyway
    return jax.jit(shard_map(fn, mesh=mesh, in_specs=in_specs,
                             out_specs=_RESULT_SPECS, check_vma=False))


def pallas_align_on_mesh(cfg: AlignConfig, max_windows: int, mesh: Mesh,
                         text_words, text_len, pattern_words, pattern_len):
    """Sharded kernel-engine unstructured alignment."""
    _check_batch(pattern_words.shape[0], mesh)
    sh2 = pair_sharding(mesh, 0, 2)
    sh1 = pair_sharding(mesh, 0, 1)
    args = (jax.device_put(text_words, sh2),
            jax.device_put(text_len, sh1),
            jax.device_put(pattern_words, sh2),
            jax.device_put(pattern_len, sh1))
    return _pallas_sharded_fn(cfg, max_windows, mesh, False)(*args)


def pallas_align_mapped_on_mesh(cfg: AlignConfig, max_windows: int,
                                mesh: Mesh, genome_words, starts,
                                text_len, pattern_words, pattern_len):
    """Sharded kernel-engine read-mapping: packed genome replicated in
    every device's memory (SURVEY §5: a packed human genome is
    ~0.75 GiB), pairs sharded, per-pair window reads device-local."""
    _check_batch(pattern_words.shape[0], mesh)
    sh2 = pair_sharding(mesh, 0, 2)
    sh1 = pair_sharding(mesh, 0, 1)
    args = (jax.device_put(genome_words, replicated(mesh)),
            jax.device_put(starts, sh1),
            jax.device_put(text_len, sh1),
            jax.device_put(pattern_words, sh2),
            jax.device_put(pattern_len, sh1))
    return _pallas_sharded_fn(cfg, max_windows, mesh, True)(*args)


@functools.lru_cache(maxsize=64)
def _compact_sharded_fn(mesh: Mesh, cap: int, u8: bool, sparse: bool):
    from ..ops import engine_pallas, engine_xla as ex

    if sparse:
        inner = (engine_pallas.compact_entries_sparse_u8 if u8
                 else engine_pallas.compact_entries_sparse)
    else:
        inner = ex.compact_entries_u8 if u8 else ex.compact_entries

    def fn(entries, counts):
        return inner(entries, counts, cap)

    return jax.jit(shard_map(
        fn, mesh=mesh,
        in_specs=(P(None, None, PAIR_AXIS), P(None, PAIR_AXIS)),
        out_specs=(P(None, PAIR_AXIS), P(PAIR_AXIS)), check_vma=False))


def compact_on_mesh(mesh: Mesh, entries, counts, cap: int, u8: bool,
                    sparse: bool):
    """Device-local CIGAR-run compaction of sharded engine output (the
    flat-index binary searches must not become cross-device gathers)."""
    return _compact_sharded_fn(mesh, cap, u8, sparse)(entries, counts)


@functools.lru_cache(maxsize=64)
def _tokenize_sharded_fn(mesh: Mesh, cap: int, sparse: bool, ne3c: int):
    from ..ops import tokens

    def fn(entries, counts):
        return tokens.compact_tokenize(entries, counts, cap, sparse, ne3c)

    return jax.jit(shard_map(
        fn, mesh=mesh,
        in_specs=(P(None, None, PAIR_AXIS), P(None, PAIR_AXIS)),
        out_specs=(P(None, PAIR_AXIS), P(PAIR_AXIS), P(PAIR_AXIS)),
        check_vma=False))


def compact_tokenize_on_mesh(mesh: Mesh, entries, counts, cap: int,
                             sparse: bool, ne3c: int):
    """Device-local tokens.compact_tokenize of sharded engine output: the
    token readback path of a mesh tile."""
    return _tokenize_sharded_fn(mesh, cap, sparse, ne3c)(entries, counts)


@functools.lru_cache(maxsize=64)
def _tokens_sharded_fn(mesh: Mesh, capT: int):
    from ..ops import tokens

    def fn(toks):
        return tokens.compact_tokens(toks, capT)

    return jax.jit(shard_map(fn, mesh=mesh, in_specs=(P(None, PAIR_AXIS),),
                             out_specs=P(PAIR_AXIS, None), check_vma=False))


def compact_tokens_on_mesh(mesh: Mesh, toks, capT: int):
    """Device-local tokens.compact_tokens: lane-major (B, capT) tokens,
    pair-sharded."""
    return _tokens_sharded_fn(mesh, capT)(toks)
