"""Library API: the two align_all interfaces over the batched device engine.

Mirrors the reference's 4-overload surface (genasm_cpu.hpp:6-7,
genasm_gpu.hpp:6-7) with one Python API: ``align_pairs(texts, queries)``
(unstructured) and ``align_reads(genome, reads)`` (read-mapping against a
shared reference with candidate locations), both returning ``Alignment``
(extended CIGAR + semiglobal edit distance), dispatched by ``align_all``.

Execution model (replaces OpenMP threads / persistent CUDA blocks):
 - pairs are sorted by read length descending (the load-balance trick the
   reference applies at tests.cu:375-377) and packed into fixed-size lane
   tiles (multiples of 128),
 - per tile, one jitted lockstep scan over DP windows does everything on
   device; CIGAR runs come back packed and are stringified on host,
 - pad-dimension bucketing (linear steps) bounds the number of XLA
   retraces across calls — the analogue of the reference's
   recompile-per-config, amortized.

Per-pair failures (no alignment within K, or pathological stalls the
reference would hang on) are retried on the exact scalar path and raise
``AlignmentError`` if genuinely unalignable.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from .config import AlignConfig
from .datamodel import Alignment, Genome, PackedAlignments, Read
from . import pyref

# Mirrors genasm_cpu::enabled_algorithm_log (genasm_cpu.cpp:121); the
# "core algorithm ran at N aligns/second" stderr line is scraped by the
# profiling tooling, so its format is API (profile.py:55-63 analogue).
enabled_algorithm_log = False


class AlignmentError(ValueError):
    """A pair could not be aligned within K edits per window."""


_ENCODE_LUT = np.full(256, 255, np.uint8)
for _c, _v in zip(b"ACGTacgt", [0, 1, 2, 3, 0, 1, 2, 3]):
    _ENCODE_LUT[_c] = _v


def encode_np(seq: str) -> np.ndarray:
    """ASCII -> 2-bit codes (vectorized ascii_to_zero_based_string,
    genasm_cpu.cpp:462-493). Raises on non-ACGT."""
    raw = np.frombuffer(seq.encode("ascii"), np.uint8)
    codes = _ENCODE_LUT[raw]
    if codes.max(initial=0) == 255:
        bad = chr(raw[int(np.argmax(codes == 255))])
        raise ValueError(f"non-ACGT character in sequence: {bad!r}")
    return codes


@dataclass
class AlignStats:
    """Timing stats; core_ns mirrors the reference's core_algorithm_ns
    out-parameter (genasm_cpu.cpp:495,532-539). The transfer fields are
    telemetry for the host<->device pipeline (no reference analogue: the
    reference uses managed memory and never sees transfer costs
    explicitly). ``engine_tiles`` counts the calls per engine — device
    tiles on "pallas" (the window kernel) or "xla" (engine_xla), retry
    tiles on "escalation" (the kernel at a raised tb_cap) or "retry_xla",
    and pairs on "pyref" (the scalar oracle) — so a fallback is never
    mistaken for the kernel."""

    num_pairs: int = 0
    core_ns: int = 0
    postprocess_ns: int = 0
    retried_pairs: int = 0
    # pairs resolved by the kernel's tb_cap-escalation ladder (a subset of
    # retried_pairs that never reached the slow full-K XLA engine)
    escalated_pairs: int = 0
    # pipeline telemetry
    prep_ns: int = 0          # host-side encode/pack/tile fill
    upload_ns: int = 0        # blocking h2d transfer time
    upload_bytes: int = 0
    compact_ns: int = 0       # device-side CIGAR-run compaction compute
    readback_ns: int = 0      # blocking d2h transfer time (within postprocess)
    readback_bytes: int = 0
    format_ns: int = 0        # CIGAR stringification (within postprocess)
    # failure-reason telemetry from the kernel's per-lane reason bitmask
    # (engine_pallas.FAIL_*) — the dead-end counters the reference only
    # exposes as DEBUG asserts (genasm_cpu.cpp:362-385)
    fail_tb_pairs: int = 0         # d-search exceeded tb_cap
    fail_stall_pairs: int = 0      # zero-progress window
    fail_incomplete_pairs: int = 0  # max_windows ran out
    engine_tiles: dict = dataclasses.field(default_factory=dict)

    @property
    def aligns_per_second(self) -> float:
        return self.num_pairs * 1e9 / max(self.core_ns, 1)

    def breakdown(self) -> str:
        f = lambda ns: f"{ns/1e9:.3f}s"
        return (f"prep={f(self.prep_ns)} upload={f(self.upload_ns)}"
                f"/{self.upload_bytes/1e6:.1f}MB core={f(self.core_ns)} "
                f"compact={f(self.compact_ns)} "
                f"readback={f(self.readback_ns)}"
                f"/{self.readback_bytes/1e6:.1f}MB "
                f"format={f(self.format_ns)} retried={self.retried_pairs}"
                + (f" escalated={self.escalated_pairs}"
                   if self.escalated_pairs else "")
                + (f" fail[tb={self.fail_tb_pairs} "
                   f"stall={self.fail_stall_pairs} "
                   f"incomplete={self.fail_incomplete_pairs}]"
                   if self.retried_pairs else "")
                + " engines[" + " ".join(
                    f"{k}={v}" for k, v in sorted(self.engine_tiles.items()))
                + "]")

    def ran(self, engine: str) -> None:
        """Record one device call on ``engine`` (see engine_tiles)."""
        self.engine_tiles[engine] = self.engine_tiles.get(engine, 0) + 1

    def count_fail_reasons(self, failed_mask) -> None:
        """Aggregate the kernel's per-lane reason bitmask into the
        counters (no-op for boolean failure arrays from the XLA engine)."""
        from .ops import engine_pallas as ep

        m = np.asarray(failed_mask)
        if m.dtype == np.bool_:
            return
        self.fail_tb_pairs += int((m & ep.FAIL_TB).astype(bool).sum())
        self.fail_stall_pairs += int((m & ep.FAIL_STALL).astype(bool).sum())
        self.fail_incomplete_pairs += int(
            (m & ep.FAIL_INCOMPLETE).astype(bool).sum())


def _bucket_lin(n: int, step: int) -> int:
    """Round up to a multiple of step (tighter than power-of-two padding:
    transferred bytes and device work scale with the pad)."""
    return max(step, -(-n // step) * step)


def _tile_B(n_lanes: int, tile_size: int, mesh) -> int:
    """Device-lane count for a tile holding ``n_lanes`` real pairs.

    Full tiles use ``tile_size``; a trailing partial tile shrinks to a
    pow2 bucket (>= 1024) instead of padding all the way up — pad lanes
    are real device time, and a 10%-full trailing tile would otherwise
    nearly double a run's device cost. Pow2 bucketing bounds the number
    of extra traced kernel shapes at log2(tile/1024). Mesh tiles keep
    the full size (the per-device shard split relies on it)."""
    if mesh is not None or tile_size <= 1024 or n_lanes >= tile_size:
        return tile_size
    return min(tile_size, max(1024, 1 << (max(n_lanes, 2) - 1).bit_length()))


def _device_put_synced(*arrays, shardings=None, stats=None, force=True):
    """device_put (+ optionally wait for the transfers to complete).

    Keeps data transfer out of the timed core section (the reference's
    core_algorithm_ns likewise excludes transfers, genasm_gpu.cu:890-944).
    ``force=False`` skips the wait (for KB-sized side arrays the timing
    attribution is not worth a synchronization). With ``shardings`` the
    buffers are placed batch-sharded across the mesh directly (each
    device receives only its shard)."""
    import jax

    t0 = time.perf_counter_ns()
    if shardings is None:
        out = [jax.device_put(x) for x in arrays]
    else:
        out = [jax.device_put(x, s) for x, s in zip(arrays, shardings)]
    if force:
        jax.block_until_ready(out)
    if stats is not None:
        stats.upload_ns += time.perf_counter_ns() - t0
        stats.upload_bytes += sum(a.nbytes for a in arrays)
    return out


def _upload_rows_chunked(stats, n_rows: int, build_chunk, mesh=None,
                         chunk_rows: int = 4096):
    """Pipelined tile upload: build_chunk(c0, c1) -> np.ndarray producing
    rows [c0, c1) of a row-major buffer; chunks are device_put on an IO
    thread while the NEXT chunk is built on the main thread, then
    concatenated on device. Host prep (encode/fill/2-bit pack, all
    C/numpy, GIL-releasing) thus runs under the h2d transfer of the
    previous chunk. With ``mesh`` each chunk is one device's shard of the
    rows, put on that device, and the result is the pair-sharded array.

    Timing note: build time goes to stats.prep_ns and the enclosing wall
    to stats.upload_ns, so prep_ns overlaps (is contained in) upload_ns
    on this path."""
    import jax
    import jax.numpy as jnp
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter_ns()
    devices = [None]
    if mesh is not None:
        devices = list(mesh.devices.flat)
        chunk_rows = n_rows // len(devices)

    def put(x, device):
        # transfers are enqueued async; ONE wait at the end drains them
        d = jax.device_put(x, device)
        stats.upload_bytes += x.nbytes
        return d

    devs = []
    with ThreadPoolExecutor(max_workers=1) as up:
        futs = []
        for k, c0 in enumerate(range(0, n_rows, chunk_rows)):
            tp = time.perf_counter_ns()
            chunk = build_chunk(c0, min(c0 + chunk_rows, n_rows))
            stats.prep_ns += time.perf_counter_ns() - tp
            while len(futs) > 1:  # bounded look-ahead
                devs.append(futs.pop(0).result())
            futs.append(up.submit(put, chunk, devices[k % len(devices)]))
        for f in futs:
            devs.append(f.result())
    if mesh is not None:
        from .parallel import mesh as mesh_mod

        out = jax.make_array_from_single_device_arrays(
            (n_rows,) + devs[0].shape[1:],
            mesh_mod.pair_sharding(mesh, 0, devs[0].ndim), devs)
    else:
        out = devs[0] if len(devs) == 1 else jnp.concatenate(devs, axis=0)
    out.block_until_ready()
    stats.upload_ns += time.perf_counter_ns() - t0
    return out


def _lane_shardings(mesh, n: int):
    """Pair shardings for n per-lane (B,) arrays, or None without a mesh."""
    if mesh is None:
        return None
    from .parallel import mesh as mesh_mod

    return (mesh_mod.pair_sharding(mesh, 0, 1),) * n


def _resolve_mesh(cfg: AlignConfig):
    """All-local-devices 1-D pairs mesh, or None on a single device.

    The device count shrinks to the largest value whose per-device shard
    is still a whole number of 128-pair tiles (length-sorted batching
    keeps shards load-balanced; there is no work stealing across
    devices)."""
    import jax

    # LOCAL devices: in a multi-process run each process aligns its own
    # shard (parallel/distributed.py); a global mesh would device_put
    # host-local tiles onto non-addressable devices
    n = len(jax.local_devices())
    while n > 1 and cfg.batch_tile % (128 * n):
        n -= 1
    if n <= 1:
        return None
    from .parallel import mesh as mesh_mod

    return mesh_mod.make_mesh(n)



def _fill_rows(buffer: np.ndarray, rows):
    """Ragged-row fill: buffer[lane, :len(rows[lane])] = rows[lane].

    Per-row slice assignment is a memcpy — orders of magnitude faster than
    flattened fancy-index scatter at this scale."""
    lens = np.empty(len(rows), np.int32)
    for lane, r in enumerate(rows):
        n = len(r)
        lens[lane] = n
        if n:
            buffer[lane, :n] = r
    return lens


def _resolve_backend(cfg: AlignConfig) -> str:
    """Pick the device engine: "pallas" (the window kernel) or "xla".

    "auto" runs the kernel on a GPU whenever the config's state fits it
    (engine_pallas.choose_kernel_shape; the kernel is bit-identical to
    engine_xla) and engine_xla everywhere else: on the CPU, and for W
    past the kernel's register budget — the role of the reference GPU's
    shared->global DP memory fallback (genasm_gpu.cu:584-600). "pallas"
    insists on the kernel: it raises without a GPU unless interpret mode
    is asked for (cfg.interpret), and for configs the kernel cannot take.
    """
    import jax

    from .ops import engine_pallas

    if cfg.backend == "xla":
        return "xla"
    fits = engine_pallas.choose_kernel_shape(cfg)[0] > 0
    if cfg.backend == "pallas":
        engine_pallas.check_device(cfg)
        if not fits:
            raise ValueError(
                f"W={cfg.W}: the kernel's register state does not fit; "
                "use backend='xla'")
        return "pallas"
    if cfg.backend != "auto":
        raise ValueError(f"unknown backend {cfg.backend!r}")
    return "pallas" if fits and jax.default_backend() == "gpu" else "xla"


# Predicted compaction caps per (cfg, maxw): the slow path must SYNC the
# run/token totals before it can pick the static compaction widths (two
# extra device->host round trips per tile); once a workload's caps
# are known, the whole engine->compact->tokenize chain is dispatched
# without host involvement and lanes that overflow a predicted cap are
# failed to the exact retry path (rare by construction: caps only grow).
_cap_cache: dict = {}

# api-level failure reason: a lane overflowed a predicted compaction cap
# (its compacted output is truncated); disjoint from the kernel FAIL_*
# bits so the escalation ladder never mistakes it for a tb_cap failure.
FAIL_OVERFLOW = 8


def _cap_key(cfg, res, sparse_rows):
    # the engines' row layouts differ (the kernel's sparse rows vs
    # engine_xla's dense ones), and so do the caps they need
    return (cfg, int(res.entries.shape[0]), sparse_rows)


def _update_cap_cache(key, totals_max, tok_max, wmax, wused_max=0):
    cap = _bucket_lin(totals_max + 128, 512)
    capT = _bucket_lin(tok_max + 64, 256)
    ne3c = 1 << max(2, (max(wmax, 1) - 1).bit_length())
    # window-axis slice: max_windows carries ~1.34x deletion headroom
    # realistic reads never touch, and the compaction passes scale with
    # the window axis — cap it at the observed windows-used (bucketed;
    # overflow fails the lane to the retry, exactly like the run caps)
    wcap = _bucket_lin(wused_max + 8, 32) if wused_max else 0
    old = _cap_cache.get(key)
    if old:
        cap, capT, ne3c, wcap = (max(cap, old[0]), max(capT, old[1]),
                                 max(ne3c, old[2]), max(wcap, old[3]))
    _cap_cache[key] = (cap, capT, ne3c, wcap)


def _consume_tokens(toksc, tok_tot, stats, packed_out, t0):
    """Chunked token readback + host decode -> payload (strings or
    (flat_runs, offsets)). toksc: (B, capT) device array, lane-major."""
    from . import native

    B = int(tok_tot.shape[0])
    n_chunks = min(8, max(1, B // 4096))
    cb = -(-B // n_chunks)
    chunks = [(c0, min(c0 + cb, B)) for c0 in range(0, B, cb)]

    t_rb0 = time.perf_counter_ns()
    consume_ns = 0
    from concurrent.futures import ThreadPoolExecutor

    capT_full = int(toksc.shape[1])
    tok_np = np.asarray(tok_tot)

    def read_chunk(c0, c1):
        # toksc is lane-major (B, capT): row ranges are contiguous.
        # Columns are sliced to the CHUNK's max token count (tok_tot is
        # already host-side from the fused meta): capT is bucketed ~14%
        # above the batch max, and per-chunk maxima shave a little more —
        # 33.6 -> ~28.6 MB at the headline shape for one device slice per
        # chunk. (The dense sum of tok_tot is 25.8 MB there — the 1
        # byte/token floor of this format; the residual over it is
        # intra-chunk variance.)
        mt = min(int(tok_np[c0:c1].max(initial=0)), capT_full)
        part = np.asarray(toksc[c0:c1, :mt]) if mt else \
            np.zeros((c1 - c0, 0), np.uint8)
        stats.readback_bytes += part.nbytes
        return part

    cigars: List[str] = []
    if packed_out:
        # one batch-wide destination, chunks decode at a running offset
        # (in order, so the flat layout has no gaps): saves ~16 MB of
        # allocation per chunk + a 33 MB final concatenate
        capT = int(toksc.shape[1])
        out_full = np.empty(
            2 * int(np.minimum(tok_tot, capT).sum()), np.uint16)
        counts_full = np.empty(B, np.int64)
        pos = 0
    # two readback streams; decode of chunk c runs under the next reads
    with ThreadPoolExecutor(max_workers=2) as rb_pool:
        futs = [rb_pool.submit(read_chunk, c0, c1) for c0, c1 in chunks]
        for fut, (c0, c1) in zip(futs, chunks):
            part = fut.result()
            tc0 = time.perf_counter_ns()
            if packed_out:
                flat_c, _ = native.tokens_to_runs(
                    part, tok_tot[c0:c1], out=out_full[pos:],
                    counts=counts_full[c0:c1])
                pos += len(flat_c)
            else:
                cigars.extend(native.format_tokens(part, tok_tot[c0:c1]))
            consume_ns += time.perf_counter_ns() - tc0
    if not packed_out:  # format_ns is stringification only (API contract:
        stats.format_ns += consume_ns  # packed mode reports format_ns == 0)
    stats.readback_ns += time.perf_counter_ns() - t_rb0 - consume_ns
    stats.postprocess_ns += time.perf_counter_ns() - t0
    if not packed_out:
        return cigars
    offs = np.zeros(B + 1, np.int64)
    np.cumsum(counts_full, out=offs[1:])
    return out_full[:pos], offs


def _build_alignments(cfg, res, stats, meta=None,
                      sparse_rows=False, mesh=None, packed_out=False,
                      tns=None):
    """Stringify device results and collect failures.

    The per-window run buffer is worst-case sized, so it is compacted on
    device to the actual run count before readback (device->host bandwidth
    is the scarce resource), then — when the config's run counts fit the
    token format — re-coded to the compressed byte-token stream
    (_tokens_payload). ``meta`` is the engine_xla.batch_meta host readback
    (eds, run totals, failure mask) if the caller already synced it.
    sparse_rows selects the kernel's sparse-row entry layout
    (engine_pallas.compact_entries_sparse) over the dense engine_xla one.
    With ``mesh``, compaction runs shard_mapped so its flat-index binary
    searches stay device-local instead of becoming cross-device gathers.
    With ``packed_out`` the formatting step is skipped entirely and the
    second return value is ``(runs_u16_flat, offsets)`` in lane order —
    the return_packed payload.
    """
    import jax.numpy as jnp

    from . import native
    from .ops import tokens as tokens_mod
    from .ops.engine_pallas import (
        compact_entries_sparse,
        compact_entries_sparse_u8,
    )
    from .ops.engine_xla import batch_meta, compact_entries, compact_entries_u8
    from .ops.postprocess import entries_to_cigars

    if sparse_rows:
        compact_entries = compact_entries_sparse
        compact_entries_u8 = compact_entries_sparse_u8

    compact_tokenize = tokens_mod.compact_tokenize
    compact_tokens = tokens_mod.compact_tokens
    if mesh is not None:  # the same passes, shard-local on every device
        from .parallel import mesh as mesh_mod

        def compact_tokenize(e, c, cap, sparse, ne3c):  # noqa: F811
            return mesh_mod.compact_tokenize_on_mesh(mesh, e, c, cap,
                                                     sparse, ne3c)

        def compact_tokens(toks, capT):  # noqa: F811
            return mesh_mod.compact_tokens_on_mesh(mesh, toks, capT)

    tokens_ok = (tokens_mod.supports(cfg)
                 and native.get_ext() is not None and meta is None)
    pred = _cap_cache.get(_cap_key(cfg, res, sparse_rows)) if tokens_ok else None
    if pred:
        # FAST PATH: the whole engine->compact->tokenize->slice chain is
        # dispatched with PREDICTED static caps, then ONE fused readback
        # returns meta + token totals — no mid-pipeline cap sync (two
        # device->host round trips on the slow path). Lanes that
        # overflow a predicted cap have truncated output and are failed
        # to the exact retry path; the cache then grows for the next tile.
        t0 = time.perf_counter_ns()
        cap, capT, ne3c, wcap = pred
        ent_in, cnt_in = res.entries, res.counts
        if 0 < wcap < ent_in.shape[0]:
            ent_in, cnt_in = ent_in[:wcap], cnt_in[:wcap]
        toks2, _, tok_tot_dev = compact_tokenize(
            ent_in, cnt_in, cap, sparse_rows, ne3c)
        toksc = compact_tokens(toks2, capT)
        meta5 = np.asarray(tokens_mod.fused_meta(res, tok_tot_dev))
        if tns is not None:
            # the single sync covers engine + compaction compute; the
            # split core/compact attribution only exists on the slow path
            stats.core_ns += time.perf_counter_ns() - tns
        stats.compact_ns += time.perf_counter_ns() - t0
        eds_host, totals_host, failed = meta5[0], meta5[1], meta5[2]
        wmax_l, wused_l, tok_tot = meta5[3], meta5[4], meta5[5]
        over = ((totals_host > cap) | (tok_tot > capT)
                | (wmax_l > ne3c)
                | ((wused_l > wcap) if wcap else False)).astype(np.int32)
        failed = failed | (over * FAIL_OVERFLOW)
        if sparse_rows:  # kernel reason bits only (mask api overflow bit)
            stats.count_fail_reasons(failed & 15)
        _update_cap_cache(_cap_key(cfg, res, sparse_rows),
                          int(totals_host.max(initial=0)),
                          int(tok_tot.max(initial=0)),
                          int(wmax_l.max(initial=0)),
                          int(wused_l.max(initial=0)))
        payload = _consume_tokens(toksc, tok_tot, stats, packed_out, t0)
        return eds_host, payload, failed

    if meta is None:
        meta = np.asarray(batch_meta(res))
        if tns is not None:
            stats.core_ns += time.perf_counter_ns() - tns
    eds_host, totals_host, failed = meta[0], meta[1], meta[2]
    if sparse_rows:  # only the kernel's mask is a reason bitmask
        stats.count_fail_reasons(failed)

    if tokens_mod.supports(cfg) and native.get_ext() is not None:
        # slow path: pick the static caps from the synced totals, then
        # populate the cap cache so subsequent tiles take the fast path.
        # Coarse buckets bound retraces across tiles.
        t0 = time.perf_counter_ns()
        cap = _bucket_lin(max(int(totals_host.max(initial=0)), 1), 512)
        wmax = int(meta[3].max(initial=0)) if meta.shape[0] > 3 else 0
        ne3c = 1 << max(2, (max(wmax, 1) - 1).bit_length()) if wmax else 0
        wused_max = int(meta[4].max(initial=0)) if meta.shape[0] > 4 else 0
        wcap = _bucket_lin(wused_max + 8, 32) if wused_max else 0
        ent_in, cnt_in = res.entries, res.counts
        if 0 < wcap < ent_in.shape[0]:
            ent_in, cnt_in = ent_in[:wcap], cnt_in[:wcap]
        toks2, _, tok_tot_dev = compact_tokenize(
            ent_in, cnt_in, cap, sparse_rows, ne3c)
        tok_tot = np.asarray(tok_tot_dev)  # sync: picks the token cap
        capT = _bucket_lin(max(int(tok_tot.max(initial=0)), 1), 256)
        toksc = compact_tokens(toks2, capT)
        stats.compact_ns += time.perf_counter_ns() - t0
        _update_cap_cache(_cap_key(cfg, res, sparse_rows),
                          int(totals_host.max(initial=0)),
                          int(tok_tot.max(initial=0)), wmax, wused_max)
        payload = _consume_tokens(toksc, tok_tot, stats, packed_out, t0)
        return eds_host, payload, failed

    cap = _bucket_lin(max(int(totals_host.max(initial=0)), 1), 128)

    t0 = time.perf_counter_ns()
    use_u8 = cfg.tb_limit <= 63 and native.get_lib() is not None
    if mesh is not None:
        def compact_entries(e, c, cap):  # noqa: F811 - mesh override
            return mesh_mod.compact_on_mesh(mesh, e, c, cap, False,
                                            sparse_rows)

        def compact_entries_u8(e, c, cap):  # noqa: F811
            return mesh_mod.compact_on_mesh(mesh, e, c, cap, True,
                                            sparse_rows)

    fmt = native.format_cigars_u8 if use_u8 else native.format_cigars
    compactor = compact_entries_u8 if use_u8 else compact_entries
    compacted, totals = compactor(res.entries, res.counts, cap)
    np.asarray(jnp.ravel(compacted)[:1])  # force: splits compute from d2h
    stats.compact_ns += time.perf_counter_ns() - t0
    # chunked column readback: d2h of chunk c+1 is a network wait that
    # releases the GIL, so C++ formatting of chunk c runs under it —
    # d2h and stringification fully overlap on a single-core host
    B = int(res.counts.shape[-1])
    n_chunks = min(8, max(1, B // 4096))
    cb = B // n_chunks
    chunks = [(c0, min(c0 + cb, B)) for c0 in range(0, B, cb)]
    tot_np = np.asarray(totals)
    from concurrent.futures import ThreadPoolExecutor

    def read_chunk(c0, c1):
        tr0 = time.perf_counter_ns()
        part = np.asarray(compacted[:, c0:c1])
        stats.readback_ns += time.perf_counter_ns() - tr0
        stats.readback_bytes += part.nbytes
        return part

    def to_u16(part):
        return (((part.astype(np.uint16) >> 6) << 12) | (part & 0x3F)
                if use_u8 else part)

    def fmt_chunk(part, tots):
        out = fmt(part, tots)
        if out is None:  # native formatter bailed: numpy fallback
            out = entries_to_cigars(to_u16(part), tots)
        return out

    payload: Union[List[str], tuple]
    if packed_out:
        # skip stringification: read the packed columns back (chunked so
        # extraction overlaps the next chunk's d2h) and extract each
        # lane's valid runs in LANE-MAJOR contiguous order — per-lane
        # slices of the result are then contiguous views, so the final
        # PackedAlignments concatenation is memcpy-speed (column views of
        # the (cap, B) buffer stride B elements and concatenate ~10x
        # slower)
        flats = []
        with ThreadPoolExecutor(max_workers=1) as rb_pool:
            fut = rb_pool.submit(read_chunk, *chunks[0])
            for ci, (c0, c1) in enumerate(chunks):
                part = fut.result()
                if ci + 1 < len(chunks):
                    fut = rb_pool.submit(read_chunk, *chunks[ci + 1])
                t = tot_np[c0:c1]
                ext = native.extract_runs(part, t)
                if ext is None:  # no compiler: numpy gather fallback
                    lane_major = np.ascontiguousarray(to_u16(part).T)
                    m = (np.arange(lane_major.shape[1])[None, :]
                         < t[:, None])
                    ext = lane_major[m]
                flats.append(ext)
        flat = flats[0] if len(flats) == 1 else np.concatenate(flats)
        offs = np.zeros(B + 1, np.int64)
        np.cumsum(tot_np, out=offs[1:])
        payload = (flat, offs)
    else:
        cigars: List[str] = []
        if native.get_lib() is None:
            ent_np = np.asarray(compacted)
            cigars = entries_to_cigars(to_u16(ent_np), tot_np)
        else:
            with ThreadPoolExecutor(max_workers=1) as rb_pool:
                fut = rb_pool.submit(read_chunk, *chunks[0])
                for ci, (c0, c1) in enumerate(chunks):
                    part = fut.result()
                    if ci + 1 < len(chunks):
                        fut = rb_pool.submit(read_chunk, *chunks[ci + 1])
                    tf0 = time.perf_counter_ns()
                    cigars.extend(fmt_chunk(part, tot_np[c0:c1]))
                    stats.format_ns += time.perf_counter_ns() - tf0
        payload = cigars
    stats.postprocess_ns += time.perf_counter_ns() - t0
    return eds_host, payload, failed


def _runs_from_cigar(cigar: str) -> np.ndarray:
    """CIGAR string -> uint16 packed runs (retry-path pairs only; the
    device lanes never round-trip through strings in packed mode)."""
    from .cigar import parse_cigar

    ops = PackedAlignments.OPS
    out: List[int] = []
    for count, op in parse_cigar(cigar):
        code = ops.index(op) << 12
        while count > 0x0FFF:
            out.append(code | 0x0FFF)
            count -= 0x0FFF
        out.append(code | count)
    return np.array(out, np.uint16)


def _assemble_packed_parts(n: int, parts, results) -> PackedAlignments:
    """Merge device tiles' lane-order packed payloads + retry Alignments
    into one pair-order PackedAlignments.

    parts: (flat, offs, idxs, eds, failed) per tile — tile lane ``k`` maps
    to pair index ``idxs[k]``; failed lanes defer to ``results`` (filled by
    the retry path). Assembly is two vectorized passes (length scatter,
    then a native permutation memcpy) instead of the per-pair view +
    concatenate walk, which measured slower than the string path it was
    meant to beat.
    """
    from . import native

    eds_out = np.zeros(n, np.int32)
    lens = np.zeros(n, np.int64)
    retry_runs = {}
    for i, r in enumerate(results):
        if isinstance(r, Alignment):
            runs = _runs_from_cigar(r.cigar)
            retry_runs[i] = runs
            lens[i] = len(runs)
            eds_out[i] = r.edit_distance
    if not retry_runs:
        # Identity fast path: nothing failed and every tile's lanes are
        # already in pair order as consecutive ranges (the equal-length
        # headline shape: the stable length sort is the identity). One
        # tile returns zero-copy; multiple tiles stitch with one
        # concatenate (a single memcpy) instead of the ~0.2s
        # scatter/memcpy pass. The bench's tile-16384 operating point is
        # two tiles, so the multi-tile case is the production shape.
        pos = 0
        identity = True
        for flat, offs, idxs, eds, failed in parts:
            k = len(idxs)
            if (offs.shape[0] != k + 1
                    or np.asarray(failed[:k]).any()
                    or not np.array_equal(np.asarray(idxs),
                                          np.arange(pos, pos + k))):
                identity = False
                break
            pos += k
        if identity and pos == n:
            if len(parts) == 1:
                flat, offs, idxs, eds, failed = parts[0]
                return PackedAlignments(
                    np.asarray(eds[:n], np.int32), offs,
                    flat[: int(offs[-1])] if len(flat) > int(offs[-1])
                    else flat)
            out_offs = np.zeros(n + 1, np.int64)
            pos = 0
            base = 0
            flats = []
            for flat, offs, idxs, eds, failed in parts:
                k = len(idxs)
                out_offs[pos + 1 : pos + k + 1] = offs[1:] + base
                eds_out[pos : pos + k] = np.asarray(eds[:k])
                flats.append(flat[: int(offs[-1])])
                base += int(offs[-1])
                pos += k
            return PackedAlignments(eds_out, out_offs,
                                    np.concatenate(flats))
    sel = []  # (flat, src_offs, dst_idx, src_lens) per tile
    for flat, offs, idxs, eds, failed in parts:
        k = len(idxs)
        idx_arr = np.asarray(idxs, np.int64)
        ok = np.asarray(failed[:k]) == 0
        src_lens = offs[1 : k + 1] - offs[:k]
        dst = idx_arr[ok]
        lens[dst] = src_lens[ok]
        eds_out[dst] = np.asarray(eds[:k])[ok]
        sel.append((flat, offs[:k][ok], dst, src_lens[ok]))
    out_offs = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=out_offs[1:])
    out = np.empty(int(out_offs[-1]), np.uint16)
    for flat, src_offs, dst, src_lens in sel:
        if not native.scatter_runs(flat, src_offs, dst, src_lens, out,
                                   out_offs):
            for o, i, ln in zip(src_offs, dst, src_lens):
                out[out_offs[i] : out_offs[i] + ln] = flat[o : o + ln]
    for i, runs in retry_runs.items():
        out[out_offs[i] : out_offs[i] + len(runs)] = runs
    return PackedAlignments(eds_out, out_offs, out)


def _assemble_packed(results) -> PackedAlignments:
    """Collect per-pair results — (ed, runs) tuples from the device path
    or Alignment objects from retries/pyref — into one PackedAlignments."""
    n = len(results)
    eds = np.empty(n, np.int32)
    offs = np.zeros(n + 1, np.int64)
    parts = []
    for i, r in enumerate(results):
        if isinstance(r, Alignment):
            runs = _runs_from_cigar(r.cigar)
            ed = r.edit_distance
        else:
            ed, runs = r
        eds[i] = ed
        offs[i + 1] = offs[i] + len(runs)
        parts.append(runs)
    flat = np.concatenate(parts) if parts else np.empty(0, np.uint16)
    return PackedAlignments(eds, offs, flat)


def _retry_pyref(cfg, text_codes: np.ndarray, pattern_codes: np.ndarray,
                 pair_idx: int) -> Alignment:
    try:
        ed, cigar = pyref.genasm(list(text_codes), list(pattern_codes), cfg)
    except ValueError as e:
        raise AlignmentError(
            f"pair {pair_idx}: no alignment within K={cfg.K} edits per "
            f"window (W={cfg.W})") from e
    return Alignment(cigar=cigar, edit_distance=ed)


def _retry_tile(cfg, part, lane_mult: int = 128):
    """Host buffers for a chunk of retry items (result_index, text_codes,
    pattern_codes, reason): uint8 text / pattern rows padded to 1024-char
    buckets, their lengths, and the window bound of the longest read."""
    B = _bucket_lin(len(part), lane_mult)
    longest = max((len(p) for _, _, p, _ in part), default=1) or 1
    P = _bucket_lin(longest, 1024)
    T = _bucket_lin(max((len(t) for _, t, _, _ in part), default=1) or 1,
                    1024)
    maxw = -(-cfg.max_windows(longest) // 32) * 32
    text = np.zeros((B, T), np.uint8)
    pattern = np.zeros((B, P), np.uint8)
    tlen = np.zeros(B, np.int32)
    plen = np.zeros(B, np.int32)
    tlen[: len(part)] = _fill_rows(text, [t for _, t, _, _ in part])
    plen[: len(part)] = _fill_rows(pattern, [p for _, _, p, _ in part])
    return text, tlen, pattern, plen, maxw


def _escalate_tb_cap(cfg, items, stats, results):
    """Kernel escalation ladder for resolvable failures.

    Lanes that failed for a reason a re-parameterized kernel can fix
    re-run on the SAME kernel, with the limiting knob raised per rung:

      FAIL_TB       d-search cap doubled (up to K: full-K coverage at
                    kernel speed, so the ladder terminates exactly)
      FAIL_OVERFLOW a predicted compaction cap truncated the output; the
                    re-run syncs fresh caps (resolved in one rung)

    Stall/incomplete failures skip the ladder (no kernel parameter fixes
    them). Returns the items still unresolved, reasons updated from the
    last rung."""
    from .ops import engine_pallas

    resolvable = engine_pallas.FAIL_TB | FAIL_OVERFLOW
    fatal = engine_pallas.FAIL_STALL | engine_pallas.FAIL_INCOMPLETE

    def eligible(reason):
        return (reason & resolvable) and not (reason & fatal)

    esc, rest = [], []
    for it in items:
        (esc if eligible(it[3]) else rest).append(it)

    cap = cfg.tb_cap
    overflow_rungs = 0
    while esc:
        if any(it[3] & engine_pallas.FAIL_TB for it in esc):
            if cap >= cfg.K:
                break  # deeper than K: only the oracle can say
            cap = min(2 * cap, cfg.K)
        elif overflow_rungs == 2:
            break
        else:  # overflow only: the cap cache has grown since
            overflow_rungs += 1
        cfg2 = dataclasses.replace(cfg, tb_cap_override=cap)
        chunk = max(cfg.batch_tile, 128)
        still = []
        for c0 in range(0, len(esc), chunk):
            part = esc[c0 : c0 + chunk]
            text, tlen, pattern, plen, maxw = _retry_tile(cfg, part)
            args = _device_put_synced(
                engine_pallas.pack_2bit_host(text), tlen,
                engine_pallas.pack_2bit_host(pattern), plen, stats=stats)
            res = engine_pallas.align_batch(cfg2, maxw, *args)
            stats.ran("escalation")
            eds, cigars, failed = _build_alignments(cfg2, res, stats,
                                                    sparse_rows=True)
            for lane, (ri, t, p, _) in enumerate(part):
                if failed[lane]:
                    still.append((ri, t, p, int(failed[lane])))
                else:
                    stats.escalated_pairs += 1
                    results[ri] = Alignment(cigar=cigars[lane],
                                            edit_distance=int(eds[lane]))
        esc = [it for it in still if eligible(it[3])]
        rest += [it for it in still if not eligible(it[3])]
    return rest + esc


def _retry_batched_xla(cfg, items, stats, results, mesh=None, engine=None):
    """Batched retry for lanes the kernel failed.

    The kernel gives up on a window whose edit distance exceeds tb_cap;
    such failures first climb the kernel's escalation ladder
    (_escalate_tb_cap), and whatever remains retries on the XLA engine,
    which searches the full K — one batched device call over all failed
    pairs avoids the ~10^3x cost cliff of per-pair scalar retries (real
    read-mapping inputs contain garbage candidate locations that fail en
    masse). Only pairs the full-K engine also rejects fall through to the
    exact scalar path, which raises AlignmentError for genuinely
    unalignable pairs.

    items: list of (result_index, text_codes, pattern_codes, reason) with
    reason the kernel's FAIL_* bitmask (engine "xla" passes 1).
    Writes Alignment objects into results[result_index]. Runs on the
    pairs mesh when one is given — decoy-heavy inputs fail thousands of
    lanes at once, and an unsharded retry would idle every other device.
    """
    from .ops import engine_xla

    if not items:
        return
    stats.retried_pairs += len(items)
    if engine == "xla":
        # the failed lanes already ran the full-K XLA engine at this very
        # config — rerunning it is deterministic. Go straight to the
        # scalar oracle, which raises AlignmentError when truly
        # unalignable.
        stats.ran("pyref")
        for ri, t, p, _ in items:
            results[ri] = _retry_pyref(cfg, t, p, ri)
        return
    if engine == "pallas" and cfg.retry_escalation and mesh is None:
        items = _escalate_tb_cap(cfg, items, stats, results)
        if not items:
            return
    lane_mult = 128 * (int(mesh.devices.size) if mesh is not None else 1)
    chunk = max(cfg.batch_tile, lane_mult)
    for c0 in range(0, len(items), chunk):
        part = items[c0 : c0 + chunk]
        text, tlen, pattern, plen, maxw = _retry_tile(cfg, part, lane_mult)
        if mesh is not None:
            from .parallel import mesh as mesh_mod

            res = mesh_mod.align_batch_on_mesh(cfg, maxw, mesh, text, tlen,
                                               pattern, plen)
        else:
            args = _device_put_synced(text, tlen, pattern, plen)
            res = engine_xla.align_batch(cfg, maxw, *args)
        stats.ran("retry_xla")
        eds, cigars, failed = _build_alignments(cfg, res, stats,
                                                mesh=mesh)
        for lane, (ri, t, p, _) in enumerate(part):
            if failed[lane]:
                stats.ran("pyref")
                results[ri] = _retry_pyref(cfg, t, p, ri)
            else:
                results[ri] = Alignment(cigar=cigars[lane],
                                        edit_distance=int(eds[lane]))


def _log_throughput(stats: AlignStats):
    if enabled_algorithm_log:
        print(
            f"core algorithm ran at {int(stats.aligns_per_second)} "
            "aligns/second",
            file=sys.stderr,
        )


def _pyref_align_pairs(texts, queries, cfg, stats):
    """Scalar-oracle backend. Encoding errors (non-ACGT) stay ValueError;
    unalignable pairs raise AlignmentError exactly like the device
    backends (whose failed lanes funnel through _retry_pyref)."""
    out = []
    tc0 = time.perf_counter_ns()
    for pair_idx, (t, q) in enumerate(zip(texts, queries)):
        tc = pyref.encode(t)
        qc = pyref.encode(q)
        try:
            ed, cigar = pyref.genasm(tc, qc, cfg)
        except ValueError as e:
            raise AlignmentError(
                f"pair {pair_idx}: no alignment within K={cfg.K} edits "
                f"per window (W={cfg.W})") from e
        out.append(Alignment(cigar=cigar, edit_distance=ed))
    stats.core_ns += time.perf_counter_ns() - tc0
    return out


def align_pairs(
    texts: Sequence[str],
    queries: Sequence[str],
    config: Optional[AlignConfig] = None,
    return_stats: bool = False,
    return_packed: bool = False,
):
    """Unstructured pairwise interface (genasm_cpu.cpp:557-609 analogue).

    Aligns queries[i] semiglobally against texts[i]. Unlike the reference's
    CPU variant, returns ALL alignments (the reference drops every other
    pair — known upstream bug, genasm_cpu.cpp:600-604, not replicated).

    return_packed=True returns a PackedAlignments instead of a list of
    Alignment: CIGARs stay in the device engines' packed-run form, skipping
    host-side stringification (the cigarlist_to_cigar role the reference
    also runs outside its timed kernel, genasm_gpu.cu:881-888).
    """
    cfg = config or AlignConfig()
    if len(texts) != len(queries):
        raise ValueError("texts and queries must have equal length")
    stats = AlignStats(num_pairs=len(texts))

    if cfg.backend == "pyref":
        out = _pyref_align_pairs(texts, queries, cfg, stats)
        if return_packed:
            out = _assemble_packed(out)
        _log_throughput(stats)
        return (out, stats) if return_stats else out

    from . import native
    from .ops import engine_pallas, engine_xla
    from .parallel import mesh as mesh_mod

    mesh = _resolve_mesh(cfg)
    n_dev = int(mesh.devices.size) if mesh is not None else 1
    engine = _resolve_backend(cfg)

    # sequences are encoded lazily per tile (fused C++ ASCII->2-bit->pack
    # when available); validation therefore happens tile by tile, and the
    # retry path re-encodes the few failed pairs from the strings
    order = sorted(range(len(texts)), key=lambda i: -len(queries[i]))
    results: List[Optional[Alignment]] = [None] * len(texts)
    retry_items: List[tuple] = []
    packed_parts: List[tuple] = []

    tile_size = cfg.batch_tile
    n_tiles = -(-len(order) // tile_size) if order else 0
    pool = None
    if n_tiles > 1:
        from concurrent.futures import ThreadPoolExecutor

        pool = ThreadPoolExecutor(max_workers=1)
    pending = None
    try:
        for t0 in range(0, len(order), tile_size):
            idxs = order[t0 : t0 + tile_size]
            B = _tile_B(len(idxs), tile_size, mesh)
            longest = max((len(queries[i]) for i in idxs), default=1) or 1
            P = _bucket_lin(longest, 1024)
            T = _bucket_lin(max((len(texts[i]) for i in idxs), default=1) or 1,
                            1024)
            # window count from the ACTUAL longest read, not the padded bucket
            # (the pad can be ~2x the data; windows cost real device time),
            # rounded up to bound the number of distinct traced maxw values
            maxw = -(-cfg.max_windows(longest) // 32) * 32

            tp0 = time.perf_counter_ns()
            tlen = np.zeros(B, np.int32)
            plen = np.zeros(B, np.int32)
            tlen[: len(idxs)] = np.fromiter((len(texts[i]) for i in idxs),
                                            np.int32, len(idxs))
            plen[: len(idxs)] = np.fromiter((len(queries[i]) for i in idxs),
                                            np.int32, len(idxs))
            stats.prep_ns += time.perf_counter_ns() - tp0

            def build_rows(seqs, width):
                def build(c0, c1, idxs=idxs, width=width, seqs=seqs):
                    # pad-lane rows ("" -> all-zero) keep the tile full
                    contents = [seqs[i] for i in idxs[c0:c1]]
                    contents += [""] * ((c1 - c0) - len(contents))
                    out = (native.encode_pack_strs(contents, width)
                           if engine == "pallas"
                           else native.encode_strs(contents, width))
                    if out is not None:
                        return out
                    rows = np.zeros((c1 - c0, width), np.uint8)
                    for r, i in enumerate(idxs[c0:c1]):
                        v = encode_np(seqs[i])
                        rows[r, : len(v)] = v
                    return (engine_pallas.pack_2bit_host(rows)
                            if engine == "pallas" else rows)
                return build

            text_dev = _upload_rows_chunked(stats, B, build_rows(texts, T),
                                            mesh)
            pattern_dev = _upload_rows_chunked(stats, B,
                                              build_rows(queries, P), mesh)
            small = _device_put_synced(tlen, plen, shardings=_lane_shardings(
                mesh, 2), stats=stats, force=False)
            args = (text_dev, small[0], pattern_dev, small[1])
            tns = time.perf_counter_ns()
            if engine == "pallas":
                if mesh is not None:
                    res = mesh_mod.pallas_align_on_mesh(cfg, maxw, mesh,
                                                        *args)
                else:
                    res = engine_pallas.align_batch(cfg, maxw, *args)
            elif mesh is not None:
                res = mesh_mod.align_batch_on_mesh(cfg, maxw, mesh, *args)
            else:
                res = engine_xla.align_batch(cfg, maxw, *args)

            stats.ran(engine)

            def postprocess(idxs=idxs, res=res, tns=tns):
                # device-completion sync via the fused meta readback on the
                # worker thread: the main loop encodes+uploads tile n+1
                # while tile n computes and reads back (prep/H2D of n+1
                # ∥ compute of n ∥ postprocess of n-1)
                eds, payload, failed = _build_alignments(
                    cfg, res, stats,
                    sparse_rows=(engine == "pallas"), mesh=mesh,
                    packed_out=return_packed, tns=tns)
                if return_packed:
                    packed_parts.append((payload[0], payload[1], idxs, eds,
                                         failed))
                if not return_packed or np.asarray(failed[:len(idxs)]).any():
                    for lane, i in enumerate(idxs):
                        if failed[lane]:
                            retry_items.append((i, encode_np(texts[i]),
                                                encode_np(queries[i]),
                                                int(failed[lane])))
                        elif not return_packed:
                            results[i] = Alignment(
                                cigar=payload[lane],
                                edit_distance=int(eds[lane]))

            if pending is not None:
                pending.result()
            pending = pool.submit(postprocess) if pool is not None else None
            if pending is None:
                postprocess()

        if pending is not None:
            pending.result()
            pending = None
    finally:
        # a failing tile (validation, upload, dispatch, or the
        # postprocess of the previous tile) must never leak the
        # worker thread or silently drop its pending future
        if pool is not None:
            pool.shutdown(wait=True, cancel_futures=True)
    _retry_batched_xla(cfg, retry_items, stats, results, mesh,
                       engine)
    if return_packed:
        packed = _assemble_packed_parts(len(texts), packed_parts, results)
        _log_throughput(stats)
        return (packed, stats) if return_stats else packed
    _log_throughput(stats)
    return (results, stats) if return_stats else results


def _prepare_genome_host(reference: Genome, engine: str):
    """Encode(+pack) the genome for one engine: (host_array, glen, gpad).

    Fused ASCII->packed-words in one C++ pass (native.encode_pack_strs)
    keeps peak host memory at ~1.25 bytes/base even for human-scale
    genomes, instead of ~8 bytes/base for a whole-genome uint32 blow-up.
    """
    from . import native
    from .ops import engine_pallas

    glen = len(reference.content)
    if glen > 0xFFFFFFFF:
        # the device gather path indexes the genome with uint32 char
        # offsets; silently wrapping would align reads at wrong loci
        raise ValueError(
            f"genome of {glen} bases exceeds the 2^32-1 device offset "
            "range; split it by chromosome or use backend='pyref'")
    # pad to a linear bucket so XLA traces once per bucket, not per genome
    # length (padding is never read: text_len clamps usable text). Linear
    # rather than power-of-two: the packed one-time upload amortizes the
    # occasional retrace, and pow2 padding doubles peak memory at worst.
    gpad = _bucket_lin(max(glen, 1), 1 << 22)
    if engine == "pallas":
        # 2-bit packed words: the genome uploads once at 1/4 the bytes and
        # window gathers pull whole words (engine_pallas docstring)
        packed = native.encode_pack_strs([reference.content], gpad)
        if packed is not None:
            return packed[0], glen, gpad
        # no compiler: numpy fallback, chunked to bound peak temps
        genome_codes = encode_np(reference.content)
        packed = np.zeros(gpad // 16, np.uint32)
        CHUNK = 1 << 24  # chars per chunk (multiple of 16)
        for s in range(0, glen, CHUNK):
            chunk = genome_codes[s : s + CHUNK]
            if len(chunk) % 16:
                chunk = np.pad(chunk, (0, 16 - len(chunk) % 16))
            packed[s // 16 : s // 16 + len(chunk) // 16] = \
                engine_pallas.pack_2bit_host(chunk[None, :])[0]
        return packed, glen, gpad
    rows = native.encode_strs([reference.content], gpad)
    if rows is not None:
        return rows[0], glen, gpad
    genome_codes = encode_np(reference.content)
    return (np.pad(genome_codes, (0, gpad - glen))
            if gpad != glen else genome_codes), glen, gpad


class PreparedGenome:
    """Device-resident packed reference for repeated align_reads calls.

    The reference keeps its genome resident in managed memory across the
    whole run (twobit_reference packs it once, genasm_gpu.cu:692-743);
    this is the explicit analogue for streamed workloads: prepare once,
    then every align_reads(prepared, chunk) call skips the genome
    encode/pack/upload (the dominant per-call cost for >=100 Mbase
    genomes). Cached per engine ("pallas"/"xla") and mesh width.
    """

    def __init__(self, reference: Genome):
        self.reference = reference
        self._dev = {}  # (engine, n_dev) -> (genome_dev, glen)

    def device_genome(self, engine: str, mesh):
        import jax
        import jax.numpy as jnp

        n_dev = int(mesh.devices.size) if mesh is not None else 1
        key = (engine, n_dev)
        if key not in self._dev:
            genome_host, glen, _ = _prepare_genome_host(self.reference,
                                                        engine)
            if mesh is not None:
                from .parallel import mesh as mesh_mod

                dev = jax.device_put(genome_host, mesh_mod.replicated(mesh))
            else:
                dev = jnp.asarray(genome_host)
            self._dev[key] = (dev, glen)
        return self._dev[key]


def prepare_genome(reference: Genome) -> PreparedGenome:
    """Pack + pin a reference genome for repeated align_reads calls."""
    return PreparedGenome(reference)


def align_reads(
    reference: Union[Genome, PreparedGenome],
    reads: Sequence[Read],
    config: Optional[AlignConfig] = None,
    return_stats: bool = False,
    return_packed: bool = False,
):
    """Read-mapping interface (genasm_cpu.cpp:495-555 analogue).

    One alignment per (read, candidate location), in read-major order. The
    reference genome is uploaded once as a flat 2-bit-coded device array
    and all window text is gathered from it by global offset — no per-pair
    text copies (the reference's shared-reference property, README.md:83-86).
    Pass a PreparedGenome (prepare_genome) to reuse the device-resident
    genome across calls when streaming read chunks.

    return_packed=True returns PackedAlignments (see align_pairs).
    """
    prepared: Optional[PreparedGenome] = None
    if isinstance(reference, PreparedGenome):
        prepared = reference
        reference = prepared.reference

    cfg = config or AlignConfig()
    pairs: List[Tuple[int, Read]] = []  # (start_in_reference, read)
    for read in reads:
        for loc in read.locations:
            pairs.append((loc.start_in_reference, read))
    stats = AlignStats(num_pairs=len(pairs))

    if cfg.backend == "pyref":
        out = []
        glen = len(reference.content)
        tc0 = time.perf_counter_ns()
        for pair_idx, (start, read) in enumerate(pairs):
            # same bounds semantics as the device path (a negative start
            # must not wrap to the genome tail via Python slicing)
            if not 0 <= start <= glen:
                raise ValueError(
                    f"candidate location {start} out of genome bounds")
            # same consumption bound as the device path's text_bound:
            # slicing the whole genome suffix would copy + encode up to
            # the full genome per pair
            bound = (cfg.max_windows(len(read.content)) * cfg.tb_limit
                     + cfg.W)
            tc = pyref.encode(reference.content[start : start + bound])
            qc = pyref.encode(read.content)
            try:
                ed, cigar = pyref.genasm(tc, qc, cfg)
            except ValueError as e:
                raise AlignmentError(
                    f"pair {pair_idx}: no alignment within K={cfg.K} "
                    f"edits per window (W={cfg.W})") from e
            out.append(Alignment(cigar=cigar, edit_distance=ed))
        stats.core_ns += time.perf_counter_ns() - tc0
        if return_packed:
            out = _assemble_packed(out)
        _log_throughput(stats)
        return (out, stats) if return_stats else out

    from . import native
    from .ops import engine_pallas, engine_xla
    from .parallel import mesh as mesh_mod

    mesh = _resolve_mesh(cfg)
    n_dev = int(mesh.devices.size) if mesh is not None else 1
    engine = _resolve_backend(cfg)

    tp0 = time.perf_counter_ns()
    # replicate/upload ONCE (mesh: the per-tile device_put inside the mesh
    # helpers then no-ops on the already-committed array — re-broadcasting
    # a ~0.78 GB packed human genome per tile would swamp the pipeline);
    # a PreparedGenome additionally reuses the device array across calls
    if prepared is None:
        prepared = PreparedGenome(reference)
    genome_dev, glen = prepared.device_genome(engine, mesh)
    stats.prep_ns += time.perf_counter_ns() - tp0
    # reads are encoded lazily inside the chunked tile upload (the encode
    # then runs under the previous chunk's h2d transfer); length-sorting
    # needs only the lengths
    qlens = [len(read.content) for _, read in pairs]

    order = sorted(range(len(pairs)), key=lambda i: -qlens[i])
    results: List[Optional[Alignment]] = [None] * len(pairs)
    retry_items: List[tuple] = []
    packed_parts: List[tuple] = []

    tile_size = cfg.batch_tile
    n_tiles = -(-len(order) // tile_size) if order else 0
    pool = None
    if n_tiles > 1:
        from concurrent.futures import ThreadPoolExecutor

        pool = ThreadPoolExecutor(max_workers=1)
    pending = None
    try:
        for t0 in range(0, len(order), tile_size):
            idxs = order[t0 : t0 + tile_size]
            B = _tile_B(len(idxs), tile_size, mesh)
            longest = max((qlens[i] for i in idxs), default=1) or 1
            P = _bucket_lin(longest, 1024)
            maxw = -(-cfg.max_windows(longest) // 32) * 32
            # usable text per lane is bounded by total possible consumption;
            # pre-clamping keeps window arithmetic in int32 even for huge genomes
            text_bound = maxw * cfg.tb_limit + cfg.W

            tp0 = time.perf_counter_ns()
            starts = np.zeros(B, np.uint32)
            tlen = np.zeros(B, np.int32)
            plen = np.zeros(B, np.int32)
            starts_l = np.fromiter((pairs[i][0] for i in idxs), np.int64,
                                   len(idxs))
            if len(starts_l) and (starts_l.min() < 0 or starts_l.max() > glen):
                bad = int(starts_l[(starts_l < 0) | (starts_l > glen)][0])
                raise ValueError(f"candidate location {bad} out of genome bounds")
            starts[: len(idxs)] = starts_l.astype(np.uint32)
            tlen[: len(idxs)] = np.minimum(glen - starts_l,
                                           text_bound).astype(np.int32)
            plen[: len(idxs)] = np.fromiter((qlens[i] for i in idxs), np.int32,
                                            len(idxs))
            stats.prep_ns += time.perf_counter_ns() - tp0

            def build_pattern_rows(c0, c1, idxs=idxs, P=P):
                # fused C++ encode+pack when available: one pass over the
                # ASCII, no uint8 intermediate (prep was the largest host
                # cost at the headline batch before this); pad-lane rows
                # ("" -> all-zero) keep the tile full
                contents = [pairs[i][1].content for i in idxs[c0:c1]]
                contents += [""] * ((c1 - c0) - len(contents))
                out = (native.encode_pack_strs(contents, P)
                       if engine == "pallas"
                       else native.encode_strs(contents, P))
                if out is not None:
                    return out
                rows = np.zeros((c1 - c0, P), np.uint8)
                for r, i in enumerate(idxs[c0:c1]):
                    q = encode_np(pairs[i][1].content)
                    rows[r, : len(q)] = q
                return (engine_pallas.pack_2bit_host(rows)
                        if engine == "pallas" else rows)

            pattern_dev = _upload_rows_chunked(stats, B, build_pattern_rows,
                                              mesh)
            small = _device_put_synced(starts, tlen, plen,
                                       shardings=_lane_shardings(mesh, 3),
                                       stats=stats, force=False)
            args = (small[0], small[1], pattern_dev, small[2])
            tns = time.perf_counter_ns()
            if engine == "pallas":
                if mesh is not None:
                    res = mesh_mod.pallas_align_mapped_on_mesh(
                        cfg, maxw, mesh, genome_dev, *args)
                else:
                    res = engine_pallas.align_batch_mapped(
                        cfg, maxw, genome_dev, *args)
            elif mesh is not None:
                res = mesh_mod.align_batch_mapped_on_mesh(
                    cfg, maxw, mesh, genome_dev, *args)
            else:
                res = engine_xla.align_batch_mapped(cfg, maxw, genome_dev, *args)
            stats.ran(engine)

            def postprocess(idxs=idxs, res=res, tns=tns, tlen=tlen):
                # the device-completion sync (the fused meta readback) runs
                # HERE, on the worker thread: the main loop goes on to
                # encode+upload tile n+1 while tile n still computes, so H2D
                # overlaps device time. With >1 tile in flight
                # core_ns can overlap upload_ns; the single-tile bench keeps
                # a clean kernel split.
                eds, payload, failed = _build_alignments(
                    cfg, res, stats,
                    sparse_rows=(engine == "pallas"), mesh=mesh,
                    packed_out=return_packed, tns=tns)
                if return_packed:
                    packed_parts.append((payload[0], payload[1], idxs, eds,
                                         failed))
                if not return_packed or np.asarray(failed[:len(idxs)]).any():
                    for lane, i in enumerate(idxs):
                        if failed[lane]:
                            start = pairs[i][0]
                            end = min(glen, start + int(tlen[lane]))
                            retry_items.append(
                                (i, encode_np(reference.content[start:end]),
                                 encode_np(pairs[i][1].content),
                                 int(failed[lane])))
                        elif not return_packed:
                            results[i] = Alignment(
                                cigar=payload[lane],
                                edit_distance=int(eds[lane]))

            # overlap host post-processing of this tile with the next tile's
            # device work (readback + C++ formatting release the GIL)
            if pending is not None:
                pending.result()
            pending = pool.submit(postprocess) if pool is not None else None
            if pending is None:
                postprocess()

        if pending is not None:
            pending.result()
            pending = None
    finally:
        # a failing tile (validation, upload, dispatch, or the
        # postprocess of the previous tile) must never leak the
        # worker thread or silently drop its pending future
        if pool is not None:
            pool.shutdown(wait=True, cancel_futures=True)
    _retry_batched_xla(cfg, retry_items, stats, results, mesh,
                       engine)
    if return_packed:
        packed = _assemble_packed_parts(len(pairs), packed_parts, results)
        _log_throughput(stats)
        return (packed, stats) if return_stats else packed
    _log_throughput(stats)
    return (results, stats) if return_stats else results


def align_all(*args, **kwargs):
    """Dispatch between the two interfaces by argument type, mirroring the
    reference's overload pair (genasm_cpu.hpp:6-7)."""
    first = args[0] if args else kwargs.get("reference", kwargs.get("texts"))
    if isinstance(first, (Genome, PreparedGenome)):
        return align_reads(*args, **kwargs)
    return align_pairs(*args, **kwargs)
