"""Fused GenASM window kernel for NVIDIA GPUs (Pallas through Triton).

Same windowed-alignment semantics as engine_xla (and therefore the scalar
oracle and the reference C++, genasm_cpu.cpp:210-438), with ALL the
windows of a read — pattern-bitmask build, GenASM DP fill, traceback with
CIGAR run emission and the window-to-window carry — in ONE kernel launch,
the original GPU kernel's whole-read loop per block (genasm_gpu.cu:537-580).

Thread mapping: one thread per pair. A block is one warp of
PAIRS_PER_BLOCK pairs stepping in lockstep through the same (d, i) loops;
early termination of the d-search and of the window loop is per warp. (The
original's other mapping, one block of W threads per pair with an
anti-diagonal wavefront, is not used here: it needs cross-thread shuffles
that the Triton route cannot express.)

Sequences are 2-bit packed, 16 bases per uint32 word (pack_2bit). Each
pair reads its own text and pattern words at its own cursor (a per-lane
gather), as the original's TwoBitArray views do (genasm_gpu.cu:162-189):
a window never copies, and pairs at distant cursors never constrain each
other.

On-chip state: the Triton route has no scratch memory, so the traceback
table R and the fill's forefront row live in per-block global buffers
(two extra outputs), lane-minor so that a warp's accesses coalesce, small
enough per block to stay in L1/L2. Everything else lives in registers.

DP fill: rows advance in bands of ``band`` rows along the text columns
(i = W .. 0). Inside a band each row takes its top / top-right neighbours
from the row above in registers; only the band's last row goes through
the forefront buffer to the next band. Traceback is a lockstep d-level
sweep with a closed-form level step (one pass over the stored columns,
then count-trailing-zeros) that emits, per level, one pair-packed row of
complete maximal CIGAR runs straight into the output.

Outputs are bit-identical to engine_xla — tests/test_engine_pallas.py
enforces it in interpret mode, chip_smoke.py on the GPU.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from ..config import AlignConfig
from . import bitvec as bv
from .engine_xla import (
    BatchResult,
    ENTRY_OP_SHIFT,
    OP_D,
    OP_EQ,
    OP_I,
    OP_NONE,
    OP_X,
    cumsum_log,
)

CHARS_PER_WORD = 16  # 2-bit codes per uint32
PAIRS_PER_BLOCK = 32  # one warp, one pair per thread
# DP rows per fill band, and the widest W the kernel takes. On an H100
# (tools/kernel_registers.py: ptxas registers per thread, kernel time on
# 2,048 10 kbp pairs) a four-row band beat a two-row one at W=64, 224 and
# 256 by 4-29% without spilling (90, 218 and 236 of 255 registers); at
# W=512 even a two-row band takes all 255 registers and spills.
FILL_BAND = 4
MAX_KERNEL_W = 256

# Per-lane failure-reason bits carried in BatchResult.failed (int32).
# The dead-end telemetry analogue of the reference's DEBUG-gated
# traceback checks (genasm_cpu.cpp:362-385); AlignStats aggregates them.
FAIL_TB = 1          # window's d-search exceeded tb_cap (no traceback found)
FAIL_STALL = 2       # window consumed no text and no pattern (would loop)
FAIL_INCOMPLETE = 4  # max_windows ran out before the read was consumed


def tb_rows(cfg: AlignConfig) -> int:
    """Per-window traceback row budget: two rows per d-level (a pending
    edit-run flush and the '='-run of that level) plus the closing pending
    flush + d==0 '=' row pair. Rows are SPARSE (empty slots are 0) but
    every non-empty row is a complete maximal CIGAR run, in order;
    compact_entries_sparse consumes them directly."""
    return 2 * cfg.tb_cap + 2


def choose_kernel_shape(cfg: AlignConfig):
    """(pairs per block, DP rows per fill band) for a config, or (0, 0)
    past MAX_KERNEL_W — such configs run on engine_xla, which keeps its DP
    state in device memory (the role of the original's DP_MEMORY_GLOBAL,
    genasm_gpu.cu:584-600). The windows per launch are always all of
    them."""
    if cfg.W > MAX_KERNEL_W:
        return 0, 0
    return PAIRS_PER_BLOCK, FILL_BAND


def r_rows(cfg: AlignConfig, band: int) -> int:
    """Rows of the per-block R buffer: d = 0..tb_cap plus the overhang of
    the last band, whose rows past tb_cap are computed but never used."""
    return cfg.tb_cap + band


def pack_2bit(codes: jnp.ndarray) -> jnp.ndarray:
    """Pack 2-bit codes (..., T) uint8 -> (..., ceil(T/16)) uint32 words,
    char k of a word in bits [2k, 2k+2) (genasm_gpu.cu:640-685 analogue)."""
    T = codes.shape[-1]
    Tw = -(-T // CHARS_PER_WORD)
    pad = Tw * CHARS_PER_WORD - T
    if pad:
        codes = jnp.pad(codes, [(0, 0)] * (codes.ndim - 1) + [(0, pad)])
    grouped = codes.reshape(codes.shape[:-1] + (Tw, CHARS_PER_WORD))
    shifts = jnp.arange(CHARS_PER_WORD, dtype=jnp.uint32) * 2
    return jnp.sum(grouped.astype(jnp.uint32) << shifts, axis=-1,
                   dtype=jnp.uint32)


def pack_2bit_host(codes: np.ndarray) -> np.ndarray:
    """Host-side pack_2bit (numpy or native): quarters the host->device
    transfer vs shipping uint8 codes. codes: (rows, T) uint8."""
    from .. import native

    out = native.pack_2bit_rows(codes)
    if out is not None:
        return out
    rows, T = codes.shape
    Tw = -(-T // CHARS_PER_WORD)
    pad = Tw * CHARS_PER_WORD - T
    if pad:
        codes = np.pad(codes, ((0, 0), (0, pad)))
    grouped = codes.reshape(rows, Tw, CHARS_PER_WORD).astype(np.uint32)
    shifts = (np.arange(CHARS_PER_WORD, dtype=np.uint32) * 2)[None, None, :]
    return (grouped << shifts).sum(axis=2, dtype=np.uint32)


# ---- multiword helpers on lists of (lanes,) uint32 words ----
#
# Every variable shift amount is kept inside [0, 31]: XLA defines a shift
# by >= 32 as 0, but Triton lowers shifts to LLVM, where such a shift is
# poison. Interpret mode cannot show the difference, so it is avoided by
# construction.

def _shl1_u32(v, W):
    """Multiword shift-left-by-1 of a word list, top word masked to W."""
    out = []
    for w in range(len(v)):
        word = v[w] << 1
        if w > 0:
            word = word | (v[w - 1] >> 31)
        out.append(word)
    out[-1] = out[-1] & jnp.uint32(bv.top_mask(W))
    return out


def _ones_shifted_u32(shift, W, nw):
    """Per-lane ones(W) << shift as a list of uint32 words."""
    out = []
    for w in range(nw):
        c = jnp.clip(shift - 32 * w, 0, 32)
        word = jnp.where(
            c >= 32, jnp.int32(0),
            jnp.int32(-1) << jnp.minimum(c, 31)).astype(jnp.uint32)
        out.append(word)
    out[-1] = out[-1] & jnp.uint32(bv.top_mask(W))
    return out


def _mw_shr_u32(words, s):
    """Right-shift a little-endian uint32 word list by per-lane amount
    s (clamped to [0, 32*len-1]): result bit t = source bit t+s."""
    nwm = len(words)
    si = jnp.clip(s, 0, 32 * nwm - 1)
    q = si >> 5
    r = (si & 31).astype(jnp.uint32)
    r_inv = (jnp.uint32(32) - r) & jnp.uint32(31)
    out = []
    for w in range(nwm):
        acc = jnp.zeros_like(words[0])
        for qq in range(nwm - w):
            lo = words[w + qq] >> r
            if w + qq + 1 < nwm:
                hi = jnp.where(r == 0, jnp.uint32(0),
                               words[w + qq + 1] << r_inv)
                lo = lo | hi
            acc = jnp.where(q == qq, lo, acc)
        out.append(acc)
    return out


def _mw_onehot_u32(t, nwm):
    """Word list with bit t set (none when t outside [0, 32*nwm))."""
    out = []
    for w in range(nwm):
        tw = t - 32 * w
        ok = (tw >= 0) & (tw < 32)
        sh = jnp.clip(tw, 0, 31).astype(jnp.uint32)
        out.append(jnp.where(ok, jnp.uint32(1) << sh, jnp.uint32(0)))
    return out


def _mw_below_u32(t, nwm):
    """Word list with bits [0, max(t, 0)) set, saturating."""
    out = []
    for w in range(nwm):
        k = jnp.clip(t - 32 * w, 0, 32)
        sh = jnp.clip(k, 0, 31).astype(jnp.uint32)
        part = (jnp.uint32(1) << sh) - jnp.uint32(1)
        out.append(jnp.where(k >= 32, jnp.uint32(0xFFFFFFFF), part))
    return out


def _mw_ctz_u32(words):
    """Index of the lowest set bit (int32), 32*len when all zero.

    The isolated low bit's index is read off five masks, one per index
    bit: Triton cannot lower lax.clz (math.ctlz) for the GPU."""
    nwm = len(words)
    res = jnp.full(words[0].shape, 32 * nwm, jnp.int32)
    for w in reversed(range(nwm)):
        x = words[w]
        lsb = x & (jnp.uint32(0) - x)
        t = jnp.full(x.shape, 32 * w, jnp.int32)
        for mask, weight in ((0xFFFF0000, 16), (0xFF00FF00, 8),
                             (0xF0F0F0F0, 4), (0xCCCCCCCC, 2),
                             (0xAAAAAAAA, 1)):
            t = t + jnp.where((lsb & jnp.uint32(mask)) != 0, weight, 0)
        res = jnp.where(x != 0, t, res)
    return res


def _mw_bit_u32(words, t):
    """Bit t of the word list as a bool (t clamped into range)."""
    nwm = len(words)
    tc = jnp.clip(t, 0, 32 * nwm - 1)
    sh = (tc & 31).astype(jnp.uint32)
    acc = jnp.zeros_like(words[0])
    for w in range(nwm):
        acc = acc | jnp.where((tc >> 5) == w,
                              (words[w] >> sh) & jnp.uint32(1),
                              jnp.uint32(0))
    return acc != 0


def _select_word(idx, values):
    """values[idx] (idx a traced scalar, values a static list) via a
    log-depth balanced select tree."""
    vals = list(values)
    bit = 1
    while len(vals) > 1:
        nxt = []
        for j in range(0, len(vals) - 1, 2):
            nxt.append(jnp.where((idx & bit) != 0, vals[j + 1], vals[j]))
        if len(vals) % 2:
            nxt.append(vals[-1])
        vals = nxt
        bit <<= 1
    return vals[0]


def _pattern_masks(pw, lane_ones, W, NW):
    """Per-char pattern bitmasks (genasm_cpu.cpp:178-198, MSB-aligned):
    global bit gb holds pattern position j = W-1-gb; bits below s = W-m
    are zeroed by lane_ones. pw: the window's aligned pattern words (char
    16g+k in bits [2k, 2k+2) of word g).

    Each word holds 16 chars, so char==c is one XOR + OR-collapse per
    word; the 16 match bits are compacted (log-step pair packing) and
    bit-reversed into their MSB-aligned place, which for a W that is not a
    multiple of 16 may straddle two words or hang below bit 0 (the
    overhang is chars past the window, shifted out)."""
    lanes = lane_ones[0].shape
    accs = [[jnp.zeros(lanes, jnp.uint32) for _ in range(NW)]
            for _ in range(4)]
    for g, val in enumerate(pw):
        base = W - 16 * (g + 1)  # global bit of the group's reversed bit 0
        for c in range(4):
            x = val ^ jnp.uint32(c * 0x55555555)
            z = x | (x >> 1)
            y = (~z) & jnp.uint32(0x55555555)
            y = (y | (y >> 1)) & jnp.uint32(0x33333333)
            y = (y | (y >> 2)) & jnp.uint32(0x0F0F0F0F)
            y = (y | (y >> 4)) & jnp.uint32(0x00FF00FF)
            y = (y | (y >> 8)) & jnp.uint32(0x0000FFFF)
            # reverse the 16 match bits (the mask is MSB-aligned)
            y = ((y & jnp.uint32(0x5555)) << 1) | ((y >> 1) & jnp.uint32(0x5555))
            y = ((y & jnp.uint32(0x3333)) << 2) | ((y >> 2) & jnp.uint32(0x3333))
            y = ((y & jnp.uint32(0x0F0F)) << 4) | ((y >> 4) & jnp.uint32(0x0F0F))
            y = ((y & jnp.uint32(0x00FF)) << 8) | ((y >> 8) & jnp.uint32(0x00FF))
            for w in range(NW):
                off = base - 32 * w  # static: where y's bit 0 lands in word w
                if off >= 32 or off <= -16:
                    continue
                part = y << off if off >= 0 else y >> (-off)
                accs[c][w] = accs[c][w] | part
    return [[(~accs[c][w]) & lane_ones[w] for w in range(NW)]
            for c in range(4)]


def _window_kernel(cfg: AlignConfig, band: int, max_windows: int,
                   tbuf_words: int, pbuf_words: int,
                   tbuf_ref, tstart_ref, tlen_ref, pbuf_ref, pstart_ref,
                   plen_ref, ent_in, cnt_in,
                   ed_ref, failed_ref, ent_ref, cnt_ref, R_ref, ff_ref):
    """Every window of PAIRS_PER_BLOCK pairs, carry included.

    Window semantics: genasm_cpu.cpp:210-438 (fill, traceback, windowing).
    ent_in / cnt_in are the zero-filled buffers aliased to ent_ref /
    cnt_ref: rows and windows the kernel never writes stay 0.
    """
    del ent_in, cnt_in
    W = cfg.W
    DCAP = cfg.tb_cap  # d-search cap; deeper windows fail to retry
    NW, FTW = cfg.num_words, cfg.first_tb_word
    NWH = cfg.num_tb_words
    COLS, TB = cfg.columns, cfg.tb_limit
    NWC = -(-COLS // 32)  # words of the per-lane traceback offset masks
    NA = -(-W // CHARS_PER_WORD)  # aligned words covering a window
    top_bit_off = (W - 1) % 32

    tlen = tlen_ref[...]
    plen = plen_ref[...]
    tstart = tstart_ref[...]
    pstart = pstart_ref[...]
    zero = jnp.zeros_like(tlen)
    zero_u = jnp.zeros(tlen.shape, jnp.uint32)

    def window_words(buf_ref, buf_words, pos):
        """The NA words of chars pos .. pos+16*NA-1, re-aligned so char c
        sits in bits [2(c%16), 2(c%16)+2) of word c//16. Reads past the
        buffer end are clamped: those chars lie beyond the lane's text or
        pattern length and are masked off."""
        wb = (pos >> 4).astype(jnp.int32)
        sh = (pos & jnp.uint32(15)) * jnp.uint32(2)
        ish = (jnp.uint32(32) - sh) & jnp.uint32(31)
        raw = [buf_ref[jnp.minimum(wb + k, buf_words - 1)]
               for k in range(NA + 1)]
        return [(raw[k] >> sh)
                | jnp.where(sh == 0, jnp.uint32(0), raw[k + 1] << ish)
                for k in range(NA)]

    def window(carry):
        win, ref_idx, read_idx, ed, done, failed = carry
        act = done == 0
        m = jnp.where(act, jnp.clip(plen - read_idx, 0, W), 0)
        n = jnp.where(act, jnp.clip(tlen - ref_idx, 0, W), 0)
        s = W - m
        lane_ones = _ones_shifted_u32(s, W, NW)
        tw = window_words(tbuf_ref, tbuf_words,
                          tstart + ref_idx.astype(jnp.uint32))
        pw = window_words(pbuf_ref, pbuf_words,
                          pstart + read_idx.astype(jnp.uint32))
        pmc = _pattern_masks(pw, lane_ones, W, NW)

        def pm_at(i):
            # the text char of column i (i is the same for every lane);
            # column W is always a start column, so its pm is unused
            ic = jnp.clip(i, 0, W - 1)
            word = _select_word(ic >> 4, tw)
            t = (word >> ((ic & 15) * 2).astype(jnp.uint32)) & jnp.uint32(3)
            out = []
            for w in range(NW):
                v = pmc[0][w]
                for c in range(1, 4):
                    v = jnp.where(t == c, pmc[c][w], v)
                out.append(v)
            return out

        # ---- DP fill (genasm_cpu.cpp:210-288), one band of rows d0.. per
        # pass. Row d at column i: right = (d, i+1), top = (d-1, i),
        # top-right = (d-1, i+1); the recurrence is genasm_cpu.cpp:246-251.
        def band_pass(d0, is_zero):
            # is_zero is a PYTHON bool: the d=0 band is peeled so that only
            # it carries the match-only recurrence of row 0
            ones_k = [_ones_shifted_u32(s + d0 + k, W, NW)
                      for k in range(band)]

            def step(store_r, t, st):
                i = W - t  # W .. 0
                vals, shs, fr, fr_sh = st
                pm = pm_at(i)
                start = i >= n
                if not is_zero:
                    ftop = [ff_ref[i, w, :] for w in range(NW)]
                    ftop_sh = _shl1_u32(ftop, W)
                new_vals, new_shs = [], []
                for k in range(band):
                    if k == 0:
                        if not is_zero:
                            top_sh, tr, tr_sh = ftop_sh, fr, fr_sh
                    else:
                        top_sh = new_shs[k - 1]
                        tr, tr_sh = vals[k - 1], shs[k - 1]
                    row = []
                    for w in range(NW):
                        mat = shs[k][w] | pm[w]
                        if is_zero and k == 0:
                            v = mat
                        else:
                            v = mat & tr_sh[w] & top_sh[w] & tr[w]
                        row.append(jnp.where(start, ones_k[k][w], v))
                    new_vals.append(row)
                    new_shs.append(_shl1_u32(row, W))
                    if store_r:
                        for w in range(NWH):
                            R_ref[d0 + k, i, w, :] = row[FTW + w]
                for w in range(NW):
                    ff_ref[i, w, :] = new_vals[-1][w]
                if is_zero:
                    return new_vals, new_shs, fr, fr_sh
                return new_vals, new_shs, ftop, ftop_sh

            z = [zero_u] * NW
            st = ([z] * band, [z] * band, z, z)
            # columns >= COLS are never traced back: no R store there
            st = lax.fori_loop(0, W + 1 - COLS,
                               functools.partial(step, False), st)
            st = lax.fori_loop(W + 1 - COLS, W + 1,
                               functools.partial(step, True), st)
            return st[0]  # each band row at column 0 (the probe column)

        def probe(vals, d0, found, wed):
            for k in range(band):
                hit = (((vals[k][NW - 1] >> top_bit_off) & 1) == 0) \
                    & (d0 + k <= DCAP)
                newly = hit & (found == 0)
                wed = jnp.where(newly, d0 + k, wed)
                found = jnp.where(newly, 1, found)
            return found, wed

        def d_body(st):
            d0, found, wed = st
            found, wed = probe(band_pass(d0, False), d0, found, wed)
            return d0 + band, found, wed

        def d_cond(st):
            d0, found, _ = st
            go = d0 <= DCAP
            if cfg.early_termination:
                # done lanes never probe a match: treat them as found
                pending = jnp.where((found != 0) | (done != 0), 0, 1)
                go = go & (jnp.max(pending) > 0)
            return go

        found, wed = probe(band_pass(jnp.int32(0), True), 0, zero, zero)
        _, found, wed = lax.while_loop(
            d_cond, d_body, (jnp.int32(band), found, wed))
        found = found != 0
        wed = jnp.where(found & act, wed, 0)

        # ---- traceback (genasm_cpu.cpp:290-409), lockstep d-level sweep.
        # Within one d-level a lane runs one '='-run and then at most one
        # edit op (the edit drops it to the next level), so every level
        # emits one pair-packed row: the pending edit-run flush in the low
        # halfword, the level's '='-run in the high one.
        max_d = jnp.max(wed)

        def level_body(st):
            lvl, i, j, dd, fin, pend_op, pend_cnt, nfl = st
            L = lvl - 1
            active = (fin == 0) & (dd == lvl)

            # Closed-form level step: a lane runs '='s along the diagonal
            # (i+t, j+t) until the first offset t where an edit becomes
            # legal (priority I>D>X, genasm_cpu.cpp:346-370) or a
            # TB_LIMIT/window bound ends it. At offset t the tracer reads
            #   zA(t):  bit (W-2-j-t) of R[L, i+t]    (insertion)
            #   zB0(t): bit (W-1-j-t) of R[L, i+t+1]  (deletion)
            #   zB1(t): bit (W-2-j-t) of R[L, i+t+1]  (substitution)
            # One pass over the stored columns packs these bits
            # column-indexed (bit c); a per-lane funnel shift by i (A) /
            # i+1 (B) re-indexes them by t; the run length is a ctz.
            bA = (W - 2) - j + i
            bB = (W - 1) - j + (i + 1)

            def column(cw, cb, masks):
                # column c = 32*cw + cb sets bit cb of word cw of each mask.
                # A loop, not an unrolled pass: at W=256 (128 columns) the
                # unrolled pass took the GPU compiler minutes.
                c = 32 * cw + cb
                words = [R_ref[L, c, w, :] for w in range(NWH)]
                # positions clamped for shift safety; out-of-range bits are
                # read only at offsets min(t_stop, t_term) excludes
                out = []
                for p, mask in zip((bA - c, bB - c, bB - 1 - c), masks):
                    p = jnp.clip(p, 0, W - 1)
                    wsel = words[0]
                    for wd in range(1, NWH):
                        wsel = jnp.where((p >> 5) == (FTW + wd),
                                         words[wd], wsel)
                    bit = (((wsel >> (p & 31).astype(jnp.uint32))
                            & jnp.uint32(1)) ^ jnp.uint32(1))
                    out.append(mask | (bit << cb.astype(jnp.uint32)))
                return tuple(out)

            McA, McB0, McB1 = [], [], []
            for cw in range(NWC):
                a, b0, b1 = lax.fori_loop(
                    0, min(32, COLS - 32 * cw),
                    functools.partial(column, cw),
                    (zero_u, zero_u, zero_u))
                McA.append(a)
                McB0.append(b0)
                McB1.append(b1)

            MA = _mw_shr_u32(McA, i)
            MB0 = _mw_shr_u32(McB0, i + 1)
            MB1 = _mw_shr_u32(McB1, i + 1)
            tj = (m - 1) - j  # the single offset where j+t == m-1
            tn = n - i        # offsets t >= tn have i+t >= n (i_limit)
            jbit = _mw_onehot_u32(tj, NWC)
            below = _mw_below_u32(tn, NWC)
            m_ins = [MA[w] | jbit[w] for w in range(NWC)]
            m_del = [MB0[w] & ~jbit[w] & below[w] for w in range(NWC)]
            m_sub = [(MB1[w] | jbit[w]) & below[w] for w in range(NWC)]
            stop = [m_ins[w] | m_del[w] | m_sub[w] for w in range(NWC)]
            t_stop = _mw_ctz_u32(stop)
            t_term = jnp.maximum(
                jnp.minimum(jnp.minimum(m - j, TB - i), TB - j), 0)
            run = jnp.minimum(t_stop, t_term)
            does_edit = active & (t_stop < t_term)
            op = jnp.where(
                _mw_bit_u32(m_ins, t_stop), OP_I,
                jnp.where(_mw_bit_u32(m_del, t_stop), OP_D, OP_X))

            eq = jnp.where(active, run, 0)
            edop = jnp.where(does_edit, op, OP_NONE)
            i = i + eq + jnp.where(does_edit & (op != OP_I), 1, 0)
            j = j + eq + jnp.where(does_edit & (op != OP_D), 1, 0)
            dd = dd - does_edit.astype(jnp.int32)
            fin = jnp.where(active & ~does_edit, 1, fin)

            # Pending-edit-run carry: consecutive same-op edits across
            # levels (e.g. "III") accumulate in registers and flush as ONE
            # run, so every non-empty slot is a MAXIMAL CIGAR run. A lane
            # with a pending run is always active at the next level (dd
            # drops by exactly 1 per edit), so its flush is never skipped.
            ext = ((eq == 0) & (edop != OP_NONE) & (edop == pend_op)
                   & (pend_cnt > 0))
            fl = (pend_cnt > 0) & ~ext
            lo = jnp.where(fl, (pend_op << ENTRY_OP_SHIFT) | pend_cnt, 0)
            hi = jnp.where(eq > 0, (OP_EQ << ENTRY_OP_SHIFT) | eq, 0)
            ent_ref[win, max_d - lvl, :] = lo | (hi << 16)
            nfl = nfl + fl.astype(jnp.int32) + (eq > 0).astype(jnp.int32)
            pend_cnt = jnp.where(ext, pend_cnt + 1,
                                 jnp.where(edop != OP_NONE, 1, 0))
            pend_op = edop  # when ext, edop == pend_op already
            return lvl - 1, i, j, dd, fin, pend_op, pend_cnt, nfl

        fin0 = (m <= 0).astype(jnp.int32)  # `while (j < m)` entry check
        pend_op0 = jnp.full(tlen.shape, OP_NONE, jnp.int32)
        _, i, j, dd, fin, pend_op, pend_cnt, nfl = lax.while_loop(
            lambda st: st[0] >= 1, level_body,
            (max_d, zero, zero, wed, fin0, pend_op0, zero, zero))

        # final d==0 phase: flush any pending edit run, then the
        # closed-form '=' run (check-before-step)
        active0 = (fin == 0) & (dd == 0)
        run = jnp.minimum(jnp.minimum(m - j, TB - i), TB - j)
        run = jnp.where(active0, jnp.maximum(run, 0), 0)
        fl0 = pend_cnt > 0
        lo = jnp.where(fl0, (pend_op << ENTRY_OP_SHIFT) | pend_cnt, 0)
        hi = jnp.where(run > 0, (OP_EQ << ENTRY_OP_SHIFT) | run, 0)
        ent_ref[win, max_d, :] = lo | (hi << 16)
        nfl = nfl + fl0.astype(jnp.int32) + (run > 0).astype(jnp.int32)
        i = i + run
        j = j + run
        # each emitted edit op decremented dd by exactly one, so the edits
        # the kept traceback prefix used = wed - dd
        edits_used = wed - dd

        # ---- carry update (genasm_cpu.cpp:432-435); failed is a per-lane
        # reason bitmask (FAIL_*) instead of the reference's DEBUG assert
        window_failed = act & ~found
        stalled = act & found & (i == 0) & (j == 0)
        failed = (failed
                  | jnp.where(window_failed, FAIL_TB, 0)
                  | jnp.where(stalled, FAIL_STALL, 0))
        take = act & ~window_failed & ~stalled
        ed = ed + jnp.where(take, edits_used, 0)
        ref_idx = ref_idx + jnp.where(take, i, 0)
        read_idx = read_idx + jnp.where(take, j, 0)
        done = ((read_idx >= plen) | (failed != 0)).astype(jnp.int32)
        cnt_ref[win, :] = jnp.where(take, nfl, 0)
        return win + 1, ref_idx, read_idx, ed, done, failed

    def more(carry):
        win, done = carry[0], carry[4]
        return (win < max_windows) & (jnp.max(1 - done) > 0)

    done0 = (plen <= 0).astype(jnp.int32)
    _, _, read_idx, ed, _, failed = lax.while_loop(
        more, window, (jnp.int32(0), zero, zero, zero, done0, zero))
    ed_ref[...] = ed
    failed_ref[...] = failed | jnp.where(
        (failed == 0) & (read_idx < plen), FAIL_INCOMPLETE, 0)


def check_device(cfg: AlignConfig) -> None:
    """The kernel is compiled for NVIDIA GPUs; anywhere else it runs only
    when interpret mode is asked for explicitly (cfg.interpret)."""
    if not cfg.interpret and jax.default_backend() != "gpu":
        raise RuntimeError(
            "the Pallas window kernel needs a GPU (found backend "
            f"{jax.default_backend()!r}); use backend='xla', or "
            "AlignConfig(interpret=True) to run it in the interpreter")


@functools.partial(jax.jit, static_argnums=(0, 1))
def _align(cfg: AlignConfig, max_windows: int, tbuf, tstart, tlen,
           pbuf, pstart, plen) -> BatchResult:
    """Run the window kernel over a batch. tbuf / pbuf: flat uint32
    pack_2bit word buffers; tstart / pstart: (B,) uint32 char offset of
    each lane's text / pattern in them; tlen / plen: (B,) lengths."""
    check_device(cfg)
    bl, band = choose_kernel_shape(cfg)
    if not bl:
        raise ValueError(
            f"W={cfg.W}: the kernel's register state does not fit; "
            "use backend='xla'")
    B = tlen.shape[0]
    Bp = -(-B // bl) * bl  # whole blocks; pad lanes have length 0 (done)
    if Bp != B:
        def pad(x):
            return jnp.pad(x, (0, Bp - B))
        tstart, tlen, pstart, plen = map(pad, (tstart, tlen, pstart, plen))
    NE3H = tb_rows(cfg) // 2
    lane = pl.BlockSpec((bl,), lambda t: (t,))

    def whole(x):
        return pl.BlockSpec(x.shape, lambda t: (0,))

    ent_spec = pl.BlockSpec((max_windows, NE3H, bl), lambda t: (0, 0, t))
    cnt_spec = pl.BlockSpec((max_windows, bl), lambda t: (0, t))
    nrows = r_rows(cfg, band)
    r_spec = pl.BlockSpec((nrows, cfg.columns, cfg.num_tb_words, bl),
                          lambda t: (0, 0, 0, t))
    ff_spec = pl.BlockSpec((cfg.W + 1, cfg.num_words, bl),
                           lambda t: (0, 0, t))
    ent0 = jnp.zeros((max_windows, NE3H, Bp), jnp.int32)
    cnt0 = jnp.zeros((max_windows, Bp), jnp.int32)
    ed, failed, entries, counts, _, _ = pl.pallas_call(
        functools.partial(_window_kernel, cfg, band, max_windows,
                          tbuf.shape[0], pbuf.shape[0]),
        grid=(Bp // bl,),
        in_specs=[whole(tbuf), lane, lane, whole(pbuf), lane, lane,
                  ent_spec, cnt_spec],
        out_specs=[lane, lane, ent_spec, cnt_spec, r_spec, ff_spec],
        out_shape=[
            jax.ShapeDtypeStruct((Bp,), jnp.int32),  # edit distance
            jax.ShapeDtypeStruct((Bp,), jnp.int32),  # failure reasons
            jax.ShapeDtypeStruct(ent0.shape, jnp.int32),  # level runs
            jax.ShapeDtypeStruct(cnt0.shape, jnp.int32),  # runs/window
            # per-block R table and forefront (no scratch on this route)
            jax.ShapeDtypeStruct(
                (nrows, cfg.columns, cfg.num_tb_words, Bp), jnp.uint32),
            jax.ShapeDtypeStruct((cfg.W + 1, cfg.num_words, Bp),
                                 jnp.uint32),
        ],
        input_output_aliases={6: 2, 7: 3},
        compiler_params=pl_triton.CompilerParams(num_warps=bl // 32,
                                                 num_stages=1),
        backend="triton",
        interpret=cfg.interpret,
        name="genasm_windows",
    )(tbuf, tstart.astype(jnp.uint32), tlen.astype(jnp.int32),
      pbuf, pstart.astype(jnp.uint32), plen.astype(jnp.int32), ent0, cnt0)
    # SPARSE rows (tb_rows wide, returned PAIR-PACKED: (maxw, NE3/2, B)
    # int32, rows (2j, 2j+1) in the low/high halfwords): non-empty slots
    # are complete maximal runs in order. The unpack is deferred into the
    # consumers' jits (unpack_entry_pairs), where XLA fuses it into their
    # first elementwise pass.
    return BatchResult(edit_distance=ed[:B], failed=failed[:B],
                       entries=entries[:, :, :B], counts=counts[:, :B])


def _row_starts(B: int, row_words: int):
    """Char offset of each row of a row-major (B, row_words) word buffer."""
    return jnp.arange(B, dtype=jnp.uint32) * jnp.uint32(
        row_words * CHARS_PER_WORD)


@functools.partial(jax.jit, static_argnums=(0, 1))
def align_batch(cfg: AlignConfig, max_windows: int, text_words, text_len,
                pattern_words, pattern_len) -> BatchResult:
    """Kernel-engine unstructured batch alignment. text_words /
    pattern_words: (B, ceil(T/16)) / (B, ceil(P/16)) uint32 pack_2bit
    words (pack on host with pack_2bit_host)."""
    B, Tw = text_words.shape
    Pw = pattern_words.shape[1]
    return _align(cfg, max_windows, text_words.reshape(B * Tw),
                  _row_starts(B, Tw), text_len,
                  pattern_words.reshape(B * Pw), _row_starts(B, Pw),
                  pattern_len)


@functools.partial(jax.jit, static_argnums=(0, 1))
def align_batch_mapped(cfg: AlignConfig, max_windows: int, genome_words,
                       starts, text_len, pattern_words,
                       pattern_len) -> BatchResult:
    """Kernel-engine read-mapping alignment: one shared 2-bit-packed
    genome in device memory (uint32 words, pack_2bit layout) that every
    lane reads at its own global char offset — the reference's
    shared-reference views (genasm_gpu.cu:692-743) without per-pair
    copies. starts: (B,) uint32 global char offsets; pattern_words:
    (B, ceil(P/16)) uint32 pack_2bit words."""
    B, Pw = pattern_words.shape
    return _align(cfg, max_windows, genome_words, starts, text_len,
                  pattern_words.reshape(B * Pw), _row_starts(B, Pw),
                  pattern_len)


def _pack_rows_dense(entries):
    """Stable-compact each window's valid (nonzero) sparse rows into a
    dense prefix along the row axis (the two-level compaction's first
    level, ops/tokens.py).

    entries: (MAXW, NE3, B), empty slots 0. A valid row at position r
    with j-1 valid rows above it must shift down by d = r+1 - vcum[r], and
    d is non-decreasing in r — so a log-depth sequence of conditional
    power-of-two down-shifts (move iff bit k of the remaining distance is
    set, LSB first) routes every row to its target without collisions
    (validated against a scalar oracle in tests/test_engine_pallas.py).
    ~2 log2(NE3) elementwise passes over the run store, no gathers."""
    maxw, ne3, b = entries.shape
    valid = entries != 0
    vcum = cumsum_log(valid.astype(jnp.uint8), axis=1)
    riota = jnp.arange(1, ne3 + 1, dtype=jnp.uint8)[None, :, None]
    dist = jnp.where(valid, riota - vcum, jnp.uint8(0))
    ent = entries
    k = 1
    while k < ne3:
        src_e = jnp.pad(ent, ((0, 0), (0, k), (0, 0)))[:, k:, :]
        src_d = jnp.pad(dist, ((0, 0), (0, k), (0, 0)))[:, k:, :]
        take = (src_d & jnp.uint8(k)) != 0
        ent = jnp.where(take, src_e, ent)
        dist = jnp.where(take, src_d - jnp.uint8(k), dist)
        k *= 2
    # rows >= the window's run count may hold stale copies of rows that
    # shifted down; they are never addressed (e < count), left as-is
    return ent


def unpack_entry_pairs(packed):
    """Pair-packed engine rows (MAXW, NE3/2, B) int32 -> sparse u16 rows
    (MAXW, NE3, B): row 2j from the low halfword, 2j+1 from the high.
    Values are < 2^30, so the arithmetic >> is safe. Call this INSIDE a
    consumer's jit, so that XLA fuses it into the consumer's first
    elementwise pass instead of materializing the unpacked store."""
    maxw, ne3h, b = packed.shape
    lo = (packed & 0xFFFF).astype(jnp.uint16)
    hi = (packed >> 16).astype(jnp.uint16)
    return jnp.stack([lo, hi], axis=2).reshape(maxw, 2 * ne3h, b)


@functools.partial(jax.jit, static_argnums=(2,))
def compact_entries_sparse(entries, counts, cap: int):
    """engine_xla.compact_entries for the kernel's SPARSE rows.

    entries: the engine's pair-packed (MAXW, NE3/2, B) int32 rows (see
    unpack_entry_pairs) holding per-window traceback rows where empty
    slots are 0 and each lane's non-empty slots hold its maximal CIGAR
    runs in order; counts: (MAXW, B) int32 runs per window (== the
    nonzero slots per window). Output slot g of lane b holds the g-th run
    of that pair; slots >= total are 0. One gather-free log-shift
    compaction over the flattened (MAXW*NE3) row axis
    (engine_xla._compact_flat_logshift); validity is slot != 0."""
    maxw, ne3h, b = entries.shape
    from .engine_xla import _compact_flat_logshift

    flat = unpack_entry_pairs(entries).reshape(maxw * 2 * ne3h, b)
    out, totals = _compact_flat_logshift(flat, flat != 0, cap)
    return out.astype(jnp.uint16), totals


@functools.partial(jax.jit, static_argnums=(2,))
def compact_entries_sparse_u8(entries, counts, cap: int):
    """compact_entries_sparse with runs repacked to uint8 (op<<6|count,
    valid when tb_limit <= 63 — see engine_xla._entries_to_u8) BEFORE the
    log-shift passes, halving their traffic."""
    from .engine_xla import _compact_flat_logshift, _entries_to_u8

    maxw, ne3h, b = entries.shape
    flat = unpack_entry_pairs(entries).reshape(maxw * 2 * ne3h, b)
    out, totals = _compact_flat_logshift(_entries_to_u8(flat), flat != 0,
                                         cap)
    return out.astype(jnp.uint8), totals
