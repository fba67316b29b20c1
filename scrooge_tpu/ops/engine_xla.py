"""Batched GenASM/Scrooge engine in pure JAX (XLA path).

Runs the full windowed alignment — DP fill, traceback, CIGAR run-length
emission — for a tile of B = S*128 pairs in lockstep, as one jittable
function. This is the portable device path (any XLA backend); the Pallas
window kernel (engine_pallas) runs the same windows on GPUs with identical
outputs, and both must match the scalar oracle (pyref) bit-exactly.

Reference semantics implemented (cites into /root/reference/src/):
 - DP recurrence + boundaries: genasm_cpu.cpp:214-252
 - window edit distance probe + early termination: genasm_cpu.cpp:278-283
 - traceback rules (I>D>X>'=' priority, TB_LIMIT, trailing-delete stop,
   per-window run flushes): genasm_cpu.cpp:290-409
 - windowing driver: genasm_cpu.cpp:411-438

Design choices (no reference analogue):
 - MSB-aligned bitvector space: all window quantities are shifted left by
   s = W - m so the full-match probe is the static bit W-1 and traceback
   reads bit W-1-j; left shifts fill zeros from below, preserving exact
   semantics (see ops/bitvec.py docstring).
 - Batched lockstep replaces OpenMP threads / persistent CUDA blocks: the
   d-loop is a while_loop that stops when every lane has found its window
   distance (batched early termination); the traceback walks d-levels
   max_d..1 in lockstep so the R-row select is a scalar dynamic_slice.
 - R stores only the traceback-needed top words (the DENT optimization is
   always on device-side; output-invariant).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..config import AlignConfig
from . import bitvec as bv

# CIGAR op codes used on device; order encodes nothing — priority is
# explicit in the traceback select.
OP_EQ, OP_X, OP_I, OP_D = 0, 1, 2, 3
OP_NONE = 4
OP_CHARS = "=XID"

# packed entry = op << 12 | run_count (uint16); run counts are bounded by
# 2*tb_limit per window, < 4096 for any W <= 2048.
ENTRY_OP_SHIFT = 12
ENTRY_CNT_MASK = (1 << ENTRY_OP_SHIFT) - 1


class BatchResult(NamedTuple):
    edit_distance: jnp.ndarray  # (B,) int32
    failed: jnp.ndarray  # (B,) bool — no alignment within K / stalled
    entries: jnp.ndarray  # (MAXW, NE, B) uint16 packed CIGAR runs
    counts: jnp.ndarray  # (MAXW, B) int32 valid entries per window


def _tb_bits(rowf, i, j, n_cols, nwh, ftw, W):
    """The three DP bits one traceback step needs, via flat word gathers.

    rowf: the current d-level's stored row, flattened from
    (COLS, NWH, S*128) — per-lane word fetch is a flat jnp.take
    (an unrolled compare-accumulate over all COLS would be
    O(COLS*NWH) vector ops PER STEP, which dominates traceback at large
    W).

    Returns (zA_j1, zB_j, zB_j1): zero-tests of bit W-1-(j+1) of column
    i, and bits W-1-j / W-1-(j+1) of column i+1. For j == m-1 the values
    are unused by the caller (the jlast branch overrides them); indices
    are clipped so they stay in range.
    """
    SL = rowf.shape[0] // (n_cols * nwh)
    lane_id = jnp.arange(SL, dtype=jnp.int32).reshape(i.shape)
    gbA = W - 2 - j  # global bit of pattern position j+1
    gbB = W - 1 - j
    wdA = jnp.clip((gbA >> 5) - ftw, 0, nwh - 1)
    wdB = jnp.clip((gbB >> 5) - ftw, 0, nwh - 1)

    def fetch(col, wd):
        return jnp.take(rowf, (col * nwh + wd) * SL + lane_id)

    one = jnp.uint32(1)
    shA = (gbA & 31).astype(jnp.uint32)
    shB = (gbB & 31).astype(jnp.uint32)
    zA_j1 = ((fetch(i, wdA) >> shA) & one) == 0
    zB_j = ((fetch(i + 1, wdB) >> shB) & one) == 0
    zB_j1 = ((fetch(i + 1, wdA) >> shA) & one) == 0
    return zA_j1, zB_j, zB_j1


def _flush(entries, nfl, op, cnt, do_flush, ne):
    """Append packed (op, cnt) at per-lane index nfl where do_flush."""
    packed = ((op.astype(jnp.uint32) << ENTRY_OP_SHIFT)
              | cnt.astype(jnp.uint32)).astype(jnp.uint16)
    slot = jax.lax.broadcasted_iota(jnp.int32, (ne,) + nfl.shape, 0)
    mask = (slot == nfl[None]) & do_flush[None]
    entries = jnp.where(mask, packed[None], entries)
    nfl = nfl + do_flush.astype(jnp.int32)
    return entries, nfl


def _window_step(cfg: AlignConfig, gather_text, tlen, pattern, plen, carry):
    """One W-wide window for every lane: DP fill + traceback.

    gather_text(ref_idx (S,128)) -> (B, W) int32 window text codes;
    pattern: (B, P); tlen/plen/(carry items) shaped (S, 128).
    """
    W, K, O = cfg.W, cfg.K, cfg.O
    NW, NWH, FTW = cfg.num_words, cfg.num_tb_words, cfg.first_tb_word
    COLS, ROWS, TB = cfg.columns, cfg.rows, cfg.tb_limit
    NE = 2 * TB + 2
    B = pattern.shape[0]
    S = B // 128
    lane = (S, 128)

    ref_idx, read_idx, ed, done, failed = carry

    m = jnp.where(done, 0, jnp.clip(plen - read_idx, 0, W))
    n = jnp.where(done, 0, jnp.clip(tlen - ref_idx, 0, W))
    s = W - m
    lane_ones = bv.ones_shifted(s, W)

    # ---- window gathers (once per window) ----
    # flat 1-D takes over the padded 2-D operands
    wiota = jnp.arange(W, dtype=jnp.int32)
    wtext = gather_text(ref_idx)  # (B, W) int32
    P = pattern.shape[1]
    poff = jnp.minimum(read_idx.reshape(B, 1) + wiota[None, :], P - 1)
    pbase = (jnp.arange(B, dtype=jnp.int32) * P).reshape(B, 1)
    wpat = jnp.take(pattern.reshape(B * P), pbase + poff).astype(jnp.int32)

    # ---- pattern bitmasks (genasm_cpu.cpp:178-198, MSB-aligned) ----
    # bit b of word w (global bit gb = 32w+off) corresponds to pattern
    # position j = W-1-gb; it participates iff j < m <=> gb >= s.
    s_b = s.reshape(B)
    wpat_rev = wpat[:, ::-1]  # position gb holds pattern char at j = W-1-gb
    gb_all = jnp.arange(W, dtype=jnp.int32)
    valid = gb_all[None, :] >= s_b[:, None]  # (B, W)
    pmc = []  # per char: curPm = ~match_bits & lane_ones, (NW, S, 128)
    for c in range(4):
        match = (wpat_rev == c) & valid  # (B, W)
        words = []
        for w in range(NW):
            bits_here = min(32, W - 32 * w)
            chunk = match[:, 32 * w : 32 * w + bits_here]
            weights = jnp.asarray(
                (1 << np.arange(bits_here, dtype=np.uint64)).astype(np.uint32))
            acc = jnp.sum(chunk.astype(jnp.uint32) * weights[None, :],
                          axis=1, dtype=jnp.uint32)
            words.append(acc.reshape(lane))
        x = jnp.stack(words)
        pmc.append((~x) & lane_ones)
    pmc = jnp.stack(pmc)  # (4, NW, S, 128)

    # per-text-position pm select: PMI[i] = pmc[wtext[:, i]]  -> (W, NW, S, 128)
    pmc_b = pmc.reshape(4, NW, B).transpose(2, 0, 1)  # (B, 4, NW)
    pmi = jnp.take_along_axis(pmc_b, wtext[:, :, None], axis=1)  # (B, W, NW)
    pmi = pmi.transpose(1, 2, 0).reshape(W, NW, S, 128)

    # ---- DP fill (genasm_cpu.cpp:210-288) ----
    top_bit_off = (W - 1) % 32

    # Precompute the per-row start-column vectors ones << (s + d) for all d
    # OUTSIDE the d-loop. (XLA CPU compiles loop-variant shift chains that
    # feed nested-loop carry inits pathologically slowly; a table +
    # dynamic_slice sidesteps it and is cheaper per row anyway.)
    d_all = jnp.arange(ROWS + 2, dtype=jnp.int32)
    ones_table = jax.vmap(lambda dv: bv.ones_shifted(s + dv, W))(d_all)

    # Two-row register wavefront (same design as the Pallas kernel): each
    # i-pass fills rows d AND d+1 together — row d+1 at column i needs
    # R[i][d] (this pass's center_d) and R[i+1][d] (the carry before
    # update), both in registers — halving the pass count, the per-column
    # ff/pm slices, and the ff writes. Pair stores use a 2-row block, so
    # R carries one scratch row (d+1 == K+1 when K is even lands there
    # and is never read: wed <= K).
    def d_body(st):
        d, R, ff, found, wed = st
        ones_pair = lax.dynamic_slice(
            ones_table, (d, 0, 0, 0), (2, NW, S, 128))
        ones_d, ones_d1 = ones_pair[0], ones_pair[1]
        is_zero = d == 0

        def i_body(step, ist):
            # i descends W .. 0; the i == W column takes the all-start path
            i = W - step
            right, right1, topright, ff_, rrow = ist
            top = lax.dynamic_slice(
                ff_, (i, 0, 0, 0), (1, NW, S, 128))[0]
            cur_pm = lax.dynamic_slice(
                pmi, (jnp.minimum(i, W - 1), 0, 0, 0), (1, NW, S, 128))[0]
            is_start = i >= n  # covers i == W for every lane (n <= W)
            mat = bv.shl1(right, W) | cur_pm
            full = mat & bv.shl1(topright, W) & bv.shl1(top, W) & topright
            nonstart = jnp.where(is_zero, mat, full)
            center = jnp.where(is_start, ones_d, nonstart)
            # row d+1: top = R[i][d] = center, topright = R[i+1][d] = the
            # un-updated right carry; never the d == 0 special case
            mat1 = bv.shl1(right1, W) | cur_pm
            full1 = mat1 & bv.shl1(right, W) & bv.shl1(center, W) & right
            center1 = jnp.where(is_start, ones_d1, full1)
            ff_ = lax.dynamic_update_slice(ff_, center1[None], (i, 0, 0, 0))
            # store the traceback words; i >= COLS writes land on slot
            # COLS-1 and are overwritten by the real i == COLS-1 later
            # (i descends), so no predication is needed
            rrow = lax.dynamic_update_slice(
                rrow,
                jnp.stack([center[FTW:NW], center1[FTW:NW]])[None],
                (jnp.minimum(i, COLS - 1), 0, 0, 0, 0))
            return center, center1, top, ff_, rrow

        # constant carry inits (right/topright are never read at i == W)
        right0 = bv.zeros(W, lane)
        right10 = bv.zeros(W, lane)
        topright0 = bv.zeros(W, lane)
        rrow0 = jnp.zeros((COLS, 2, NWH, S, 128), jnp.uint32)
        center, center1, _, ff, rrow = lax.fori_loop(
            0, W + 1, i_body, (right0, right10, topright0, ff, rrow0))

        hit = ((center[NW - 1] >> top_bit_off) & 1) == 0
        newly = hit & ~found
        wed = jnp.where(newly, d, wed)
        found = found | newly
        hit1 = (((center1[NW - 1] >> top_bit_off) & 1) == 0) & (d + 1 <= K)
        newly1 = hit1 & ~found
        wed = jnp.where(newly1, d + 1, wed)
        found = found | newly1
        R = lax.dynamic_update_slice(
            R, rrow.transpose(1, 0, 2, 3, 4), (d, 0, 0, 0, 0))
        return d + 2, R, ff, found, wed

    def d_cond(st):
        d, _, _, found, _ = st
        in_range = d <= K
        if cfg.early_termination:
            return in_range & ~jnp.all(found)
        return in_range

    # ROWS + 1: one scratch row for the pair store at even K (see above)
    R0 = jnp.zeros((ROWS + 1, COLS, NWH, S, 128), jnp.uint32)
    ff0 = jnp.zeros((W + 1, NW, S, 128), jnp.uint32)
    found0 = jnp.zeros(lane, bool)
    wed0 = jnp.zeros(lane, jnp.int32)
    _, R, _, found, wed = lax.while_loop(
        d_cond, d_body, (jnp.int32(0), R0, ff0, found0, wed0))

    wed = jnp.where(found, wed, 0)

    # ---- traceback (genasm_cpu.cpp:290-409), lockstep d-level sweep ----
    i0 = jnp.zeros(lane, jnp.int32)
    j0 = jnp.zeros(lane, jnp.int32)
    fin0 = j0 >= m  # `while (j < m)` entry condition
    entries0 = jnp.zeros((NE,) + lane, jnp.uint16)
    nfl0 = jnp.zeros(lane, jnp.int32)
    cur_op0 = jnp.full(lane, OP_NONE, jnp.int32)
    cur_cnt0 = jnp.zeros(lane, jnp.int32)

    def level_body(st):
        lvl, i, j, dd, fin, cur_op, cur_cnt, nfl, entries = st
        row = lax.dynamic_slice(
            R, (lvl - 1, 0, 0, 0, 0), (1, COLS, NWH, S, 128))[0]
        rowf = row.reshape(COLS * NWH * S * 128)

        def sub_cond(sst):
            _, _, _, fin_, _, _, _, _, safety = sst
            dd_ = sst[2]
            active = ~fin_ & (dd_ == lvl)
            return jnp.any(active) & (safety < TB + 2)

        def sub_body(sst):
            i_, j_, dd_, fin_, cur_op_, cur_cnt_, nfl_, entries_, safety = sst
            active = ~fin_ & (dd_ == lvl)
            term = active & ((j_ >= m) | (i_ >= TB) | (j_ >= TB))
            fin_ = fin_ | term
            act = active & ~term

            i_limit = i_ >= n
            jlast = j_ == (m - 1)
            zA_j1, zB_j, zB_j1 = _tb_bits(rowf, i_, j_, COLS, NWH, FTW, W)
            # d > 0 is implied by lvl >= 1 (d_limit guard)
            can_ins = jnp.where(jlast, True, zA_j1)
            can_del = jnp.where(jlast, False, ~i_limit & zB_j)
            can_sub = jnp.where(jlast, ~i_limit, ~i_limit & zB_j1)

            op = jnp.where(
                can_ins, OP_I,
                jnp.where(can_del, OP_D, jnp.where(can_sub, OP_X, OP_EQ)))
            takes_i = (op == OP_D) | (op == OP_X) | (op == OP_EQ)
            takes_j = (op == OP_I) | (op == OP_X) | (op == OP_EQ)
            is_edit = op != OP_EQ

            changed = act & (op != cur_op_)
            do_flush = changed & (cur_cnt_ > 0)
            entries_, nfl_ = _flush(entries_, nfl_, cur_op_, cur_cnt_,
                                    do_flush, NE)
            cur_op_ = jnp.where(changed, op, cur_op_)
            cur_cnt_ = jnp.where(act, jnp.where(changed, 1, cur_cnt_ + 1),
                                 cur_cnt_)
            i_ = i_ + jnp.where(act & takes_i, 1, 0)
            j_ = j_ + jnp.where(act & takes_j, 1, 0)
            dd_ = dd_ - jnp.where(act & is_edit, 1, 0)
            return i_, j_, dd_, fin_, cur_op_, cur_cnt_, nfl_, entries_, safety + 1

        i, j, dd, fin, cur_op, cur_cnt, nfl, entries, _ = lax.while_loop(
            sub_cond, sub_body,
            (i, j, dd, fin, cur_op, cur_cnt, nfl, entries, jnp.int32(0)))
        return lvl - 1, i, j, dd, fin, cur_op, cur_cnt, nfl, entries

    max_d = jnp.max(wed)
    lvl0 = max_d
    _, i, j, dd, fin, cur_op, cur_cnt, nfl, entries = lax.while_loop(
        lambda st: st[0] >= 1, level_body,
        (lvl0, i0, j0, wed, fin0, cur_op0, cur_cnt0, nfl0, entries0))

    # final d==0 phase: pure '=' run, closed form (check-before-step)
    active0 = ~fin & (dd == 0)
    run = jnp.minimum(jnp.minimum(m - j, TB - i), TB - j)
    run = jnp.where(active0, jnp.maximum(run, 0), 0)
    has_run = run > 0
    same = has_run & (cur_op == OP_EQ) & (cur_cnt > 0)
    do_flush = has_run & ~same & (cur_cnt > 0)
    entries, nfl = _flush(entries, nfl, cur_op, cur_cnt, do_flush, NE)
    cur_cnt = jnp.where(has_run, jnp.where(same, cur_cnt + run, run), cur_cnt)
    cur_op = jnp.where(has_run, OP_EQ, cur_op)
    i = i + run
    j = j + run

    # trailing flush (genasm_cpu.cpp:400-403)
    entries, nfl = _flush(entries, nfl, cur_op, cur_cnt, cur_cnt > 0, NE)

    edits_used = wed - dd
    text_consumed = i
    pattern_consumed = j

    # ---- carry update (genasm_cpu.cpp:432-435) ----
    active = ~done
    window_failed = active & ~found
    stalled = active & found & (text_consumed == 0) & (pattern_consumed == 0)
    new_failed = failed | window_failed | stalled
    ed = ed + jnp.where(active & ~new_failed, edits_used, 0)
    ref_idx = ref_idx + jnp.where(active & ~new_failed, text_consumed, 0)
    read_idx = read_idx + jnp.where(active & ~new_failed, pattern_consumed, 0)
    new_done = (read_idx >= plen) | new_failed

    new_carry = (ref_idx, read_idx, ed, new_done, new_failed)
    nfl = jnp.where(active & ~new_failed, nfl, 0)
    return new_carry, (entries, nfl)


def _align_scan(cfg: AlignConfig, max_windows: int, gather_text,
                text_len, pattern, pattern_len) -> BatchResult:
    B = pattern.shape[0]
    if B % 128 != 0:
        raise ValueError("batch must be a multiple of 128 lanes")
    S = B // 128
    lane = (S, 128)
    tlen = text_len.astype(jnp.int32).reshape(lane)
    plen = pattern_len.astype(jnp.int32).reshape(lane)

    carry0 = (
        jnp.zeros(lane, jnp.int32),  # ref_idx
        jnp.zeros(lane, jnp.int32),  # read_idx
        jnp.zeros(lane, jnp.int32),  # edit distance
        plen <= 0,  # done
        jnp.zeros(lane, bool),  # failed
    )

    def scan_body(carry, _):
        # No all-done short-circuit: a data-dependent branch around the
        # window gathers compiles pathologically on XLA CPU, and finished
        # lanes are inert anyway (m = 0 -> found at d = 0, empty traceback).
        return _window_step(cfg, gather_text, tlen, pattern, plen, carry)

    carry, (entries, counts) = lax.scan(
        scan_body, carry0, None, length=max_windows)

    _, read_idx, ed, done, failed = carry
    # lanes still unfinished after max_windows are failures
    failed = failed | (read_idx < plen)

    NE = entries.shape[1]
    return BatchResult(
        edit_distance=ed.reshape(B),
        failed=failed.reshape(B),
        entries=entries.reshape(max_windows, NE, B),
        counts=counts.reshape(max_windows, B),
    )


@functools.partial(jax.jit, static_argnums=(0, 1))
def align_batch(cfg: AlignConfig, max_windows: int,
                text, text_len, pattern, pattern_len) -> BatchResult:
    """Align B = S*128 encoded pairs; returns packed per-window CIGAR runs.

    text: (B, T) uint8 2-bit codes, text_len: (B,) int32; same for pattern.
    """
    B, T = text.shape
    W = cfg.W
    wiota = jnp.arange(W, dtype=jnp.int32)
    tflat = text.reshape(B * T)
    tbase = (jnp.arange(B, dtype=jnp.int32) * T).reshape(B, 1)

    def gather_text(ref_idx):
        toff = jnp.minimum(ref_idx.reshape(B, 1) + wiota[None, :], T - 1)
        return jnp.take(tflat, tbase + toff).astype(jnp.int32)

    return _align_scan(cfg, max_windows, gather_text,
                       text_len, pattern, pattern_len)


@functools.partial(jax.jit, static_argnums=(0, 1))
def align_batch_mapped(cfg: AlignConfig, max_windows: int,
                       genome, starts, text_len,
                       pattern, pattern_len) -> BatchResult:
    """Read-mapping variant: per-lane text views into one shared genome.

    The genome stays as a single flat device array and windows are
    gathered by global offset — the equivalent of the reference's
    shared 2-bit reference views with character-granular offsets
    (genasm_gpu.cu:162-189, 692-743): no per-pair text copies.

    genome: (G,) uint8 codes; starts: (B,) uint32 global start offsets;
    text_len: (B,) int32 usable text per lane, pre-clamped by the caller to
    the consumption bound so all window-local arithmetic fits int32 even
    for >2^31-base genomes.
    """
    B = pattern.shape[0]
    G = genome.shape[0]
    W = cfg.W
    wiota = jnp.arange(W, dtype=jnp.uint32)
    starts_u = starts.astype(jnp.uint32)

    def gather_text(ref_idx):
        base = starts_u.reshape(B, 1) + ref_idx.reshape(B, 1).astype(jnp.uint32)
        idx = jnp.minimum(base + wiota[None, :], jnp.uint32(G - 1))
        return jnp.take(genome, idx).astype(jnp.int32)

    return _align_scan(cfg, max_windows, gather_text,
                       text_len, pattern, pattern_len)


@jax.jit
def batch_meta(res: BatchResult):
    """Per-lane (edit distance, run total, failure mask, max runs in any
    one window, windows used) as ONE (5, B) int32 array, so the host
    learns all five in a single d2h round trip. Row 3 sizes the two-level compaction's
    window-row slice; row 4 (the index of the last window that emitted
    runs, +1) sizes its window-axis slice — max_windows is a worst-case
    deletion-headroom bound ~1.34x the windows realistic reads touch."""
    maxw = res.counts.shape[0]
    wiota = jnp.arange(1, maxw + 1, dtype=jnp.int32)[:, None]
    return jnp.stack([
        res.edit_distance.astype(jnp.int32),
        jnp.sum(res.counts, axis=0).astype(jnp.int32),
        res.failed.astype(jnp.int32),
        jnp.max(res.counts, axis=0).astype(jnp.int32),
        jnp.max(jnp.where(res.counts > 0, wiota, 0), axis=0),
    ])


def cumsum_log(x, axis: int = 0):
    """Inclusive prefix sum via log-depth pad-shift adds.

    log2(L) shifted adds over the whole array, each a plain elementwise
    pass (~9 at the window counts' (MAXW, B) shape)."""
    n = x.shape[axis]
    sh = 1
    while sh < n:
        pad = [(0, 0)] * x.ndim
        pad[axis] = (sh, 0)
        x = x + jax.lax.slice_in_dim(jnp.pad(x, pad), 0, n, axis=axis)
        sh *= 2
    return x


def _compact_flat_logshift(flat, valid, cap: int):
    """Compact each lane's valid rows (in order) into a dense prefix of
    the flat axis, then slice the first ``cap`` rows.

    flat: (L, B) entry words (any integer dtype); valid: (L, B) bool.
    Returns (out (cap, B), totals (B,) int32).

    Entirely elementwise: the valid row at position r with j = vcum[r]-1
    valid rows at-or-before it must move down by d = r - (vcum[r]-1), and
    d is non-decreasing in r over valid rows — so LSB-first conditional
    power-of-two down-shifts (move iff bit k of the remaining distance is
    set) route every row to its slot without collisions (the
    _pack_rows_dense argument: after the bit-<k passes the remaining
    distances are the originals with low bits cleared, which preserves
    ordering, and strictly increasing targets bound any same-parity
    overtake below k). ~2·log2(L) passes over the run store. Replaces a
    per-output-element binary search + gather: shifted selects are
    plain elementwise traffic."""
    L, b = flat.shape
    cdt = jnp.uint16 if L < 0xFFFF else jnp.int32
    vcum = cumsum_log(valid.astype(cdt), axis=0)  # inclusive, (L, B)
    totals = vcum[-1].astype(jnp.int32)
    riota = jnp.arange(1, L + 1, dtype=cdt)[:, None]
    dist = jnp.where(valid, riota - vcum, cdt(0))
    ent = jnp.where(valid, flat, jnp.zeros((), flat.dtype))
    k = 1
    while k < L:
        src_e = jnp.pad(ent, ((0, k), (0, 0)))[k:]
        src_d = jnp.pad(dist, ((0, k), (0, 0)))[k:]
        take = (src_d & cdt(k)) != 0
        ent = jnp.where(take, src_e, ent)
        dist = jnp.where(take, src_d - cdt(k), dist)
        k *= 2
    if cap > L:  # caller's bucket can exceed the worst-case store
        ent = jnp.pad(ent, ((0, cap - L), (0, 0)))
    g = jnp.arange(cap, dtype=jnp.int32)[:, None]
    out = jnp.where(g < totals[None, :], ent[:cap],
                    jnp.zeros((), flat.dtype))
    return out, totals


def _dense_valid(counts, ne: int):
    """(MAXW, NE, B) validity mask for dense-prefix window rows: row e of
    window w is a real run iff e < counts[w]."""
    eiota = jnp.arange(ne, dtype=counts.dtype)[None, :, None]
    return eiota < counts[:, None, :]


def _entries_to_u8(entries):
    """Repack uint16 runs (op << 12 | count) to uint8 (op << 6 | count).
    Valid only when every run count fits 6 bits — true whenever
    tb_limit <= 63, since a single run consumes at most tb_limit text or
    pattern chars. Halves both the compaction traffic and the
    device->host readback."""
    ops = (entries >> ENTRY_OP_SHIFT).astype(jnp.uint8)
    cnts = (entries & ENTRY_CNT_MASK).astype(jnp.uint8)
    return (ops << 6) | cnts


@functools.partial(jax.jit, static_argnums=(2,))
def compact_entries(entries, counts, cap: int):
    """Concatenate each lane's valid per-window runs into (cap, B).

    entries: (MAXW, NE, B) uint16 with each window's runs in a dense
    prefix of its NE rows; counts: (MAXW, B) int32. Output slot g of
    lane b holds the g-th CIGAR run of that pair; slots >= total are 0.

    Log-shift compaction over the flattened (MAXW*NE) row axis — no
    gathers at all (see _compact_flat_logshift). Compacting on device
    also shrinks the device->host readback ~30x (the run buffer is
    worst-case sized; actual runs are few)."""
    maxw, ne, b = entries.shape
    valid = _dense_valid(counts, ne).reshape(maxw * ne, b)
    out, totals = _compact_flat_logshift(entries.reshape(maxw * ne, b),
                                         valid, cap)
    return out.astype(jnp.uint16), totals


@functools.partial(jax.jit, static_argnums=(2,))
def compact_entries_u8(entries, counts, cap: int):
    """compact_entries with the runs repacked to uint8 BEFORE compaction
    (_entries_to_u8 precondition: tb_limit <= 63), so the log-shift
    passes move half the bytes."""
    maxw, ne, b = entries.shape
    valid = _dense_valid(counts, ne).reshape(maxw * ne, b)
    flat8 = _entries_to_u8(entries).reshape(maxw * ne, b)
    out, totals = _compact_flat_logshift(flat8, valid, cap)
    return out.astype(jnp.uint8), totals
