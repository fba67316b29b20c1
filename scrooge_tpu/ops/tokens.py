"""Device-side CIGAR token compression.

The compacted CIGAR run stream is re-coded on device into a denser
byte-token stream before readback, which shrinks the device->host
transfer and the host-side decode. The reference never needs this — its
results migrate over managed memory (genasm_gpu.cu:955-958).

Input: the compacted uint8 run stream (op << 6 | count, op 0:'=' 1:'X'
2:'I' 3:'D', count in [1, 63]; compact_entries*_u8), slot g of lane b =
runs[g, b], slots >= totals zero. Token format (one uint8 per token,
tag = tok >> 5, val = tok & 31):

  tag 0      a bare '='-run of length val (1..31)
  tag 1/2/3  an X/I/D edit preceded by an '='-run of length val (0..31)
  tag 4      extend the immediately preceding edit run by val (1..31)

Most runs in real CIGARs alternate ('='-run, single edit): those pairs
collapse to ONE token, and multi-edit runs cost one extension token —
measured ~0.6x the u8 run-stream bytes at the headline workload before
padding. Requires tb_limit <= 31 so every run count fits 5 bits (the
headline configs: W=64 O=33 -> 31; W=32 O=17 -> 15). Decoding
(scroogext.cpp decode_lane) reproduces the exact run stream — CIGAR
strings stay byte-identical to the uncompressed path (tests/test_tokens.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

TAG_EXT = 4  # extend-previous-edit tag
VAL_BITS = 5
VAL_MASK = (1 << VAL_BITS) - 1


def supports(cfg) -> bool:
    """Token coding is valid when every run count fits the 5-bit val."""
    return cfg.tb_limit <= VAL_MASK


def tokenize_u8(comp: jnp.ndarray) -> jnp.ndarray:
    """Compacted u8 runs (cap, B) -> token candidates (2*cap, B) uint8.

    Slot g emits up to two tokens (rows 2g, 2g+1); zero slots are invalid
    (a valid token is never 0: tag 0 carries val >= 1, edit tags set the
    tag bits). Compact with engine_xla._compact_flat_logshift before
    readback."""
    cap, B = comp.shape
    op = comp >> 6
    cnt = (comp & 63).astype(jnp.uint8)
    valid = comp != 0  # '=' runs are their count (>=1); edits have op bits
    is_edit = valid & (op != 0)
    zero_row = jnp.zeros((1, B), comp.dtype)
    nxt = jnp.concatenate([comp[1:], zero_row])
    nxt_edit = (nxt >> 6) != 0  # zero slots decode to op 0: not an edit
    prv = jnp.concatenate([zero_row, comp[:-1]])
    prev_eq_cnt = jnp.where((prv != 0) & ((prv >> 6) == 0),
                            (prv & 63).astype(jnp.uint8), jnp.uint8(0))
    bare_eq = valid & (op == 0) & ~nxt_edit
    tok_a = jnp.where(
        is_edit, (op << VAL_BITS).astype(jnp.uint8) | prev_eq_cnt,
        jnp.where(bare_eq, cnt, jnp.uint8(0)))
    tok_b = jnp.where(is_edit & (cnt > 1),
                      jnp.uint8(TAG_EXT << VAL_BITS) | (cnt - 1),
                      jnp.uint8(0))
    return jnp.stack([tok_a, tok_b], axis=1).reshape(2 * cap, B)


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def compact_tokenize(entries, counts, cap: int, sparse: bool,
                     ne3c: int = 0):
    """Sparse/dense engine rows -> (token candidates, run totals,
    token totals), one fused device call.

    entries/counts: the engines' raw per-window run layout (see
    compact_entries[_sparse]); cap: static run-compaction width (>= max
    per-lane run total, from the counts readback). The token candidate
    buffer (2*cap, B) stays on device; the caller syncs tok_totals to
    choose the static token cap, then slices with compact_tokens.

    ne3c > 0 enables TWO-LEVEL compaction: windows are first packed to a
    dense prefix (sparse rows only) and sliced to ne3c rows (a static
    bound >= the batch's max runs in any window, from batch_meta row 3),
    and only then globally log-shift-compacted. The global passes run
    over MAXW*ne3c rows instead of MAXW*NE3 — at the headline shape
    ne3c=16 vs NE3=66 cuts the compaction's memory traffic ~4x."""
    from .engine_xla import (_compact_flat_logshift, _dense_valid,
                             _entries_to_u8)

    maxw, ne3, b = entries.shape
    if sparse:
        ne3 *= 2  # the kernel's rows arrive pair-packed
    if ne3c and ne3c < ne3:
        if sparse:
            from .engine_pallas import _pack_rows_dense, unpack_entry_pairs

            # the unpack fuses into _entries_to_u8 / the first pack pass
            # inside this jit (see unpack_entry_pairs)
            e8 = _pack_rows_dense(_entries_to_u8(unpack_entry_pairs(
                entries)))
        else:
            e8 = _entries_to_u8(entries)
        sliced = e8[:, :ne3c]
        valid = _dense_valid(counts, ne3c)
        comp, totals = _compact_flat_logshift(
            sliced.reshape(maxw * ne3c, b), valid.reshape(maxw * ne3c, b),
            cap)
        comp = comp.astype(jnp.uint8)
    else:
        from .engine_pallas import compact_entries_sparse_u8
        from .engine_xla import compact_entries_u8

        compactor = (compact_entries_sparse_u8 if sparse
                     else compact_entries_u8)
        comp, totals = compactor(entries, counts, cap)
    toks = tokenize_u8(comp)
    tok_totals = jnp.sum((toks != 0).astype(jnp.int32), axis=0)
    return toks, totals, tok_totals


@jax.jit
def fused_meta(res, tok_totals):
    """batch_meta rows + token totals as ONE (5, B) int32 readback: the
    fast path learns edit distances, run totals, failure mask, per-lane
    max window count, AND token totals in a single device->host
    round trip."""
    from .engine_xla import batch_meta

    return jnp.concatenate(
        [batch_meta(res), tok_totals[None].astype(jnp.int32)], axis=0)


@functools.partial(jax.jit, static_argnums=(1,))
def compact_tokens(toks, capT: int):
    """Log-shift-compact the token candidates and return them LANE-MAJOR
    (B, capT): the host decoder walks each lane's tokens sequentially, and
    a column-major walk (stride B) costs a cache miss per token — measured
    ~6x the whole decode. The transpose runs on device instead."""
    from .engine_xla import _compact_flat_logshift

    out, _ = _compact_flat_logshift(toks, toks != 0, capT)
    return out.T


def decode_tokens_py(toks, totals):
    """Scalar-oracle token decoder (mirrors scroogext.cpp decode_lane):
    lane-major (B, capT) token stream -> list of per-lane
    [(op, count), ...] runs. Test/fallback only — the production decode
    is the C extension."""
    import numpy as np

    toks = np.asarray(toks)
    totals = np.asarray(totals)
    B, capT = toks.shape
    out = []
    for b in range(B):
        runs = []
        pend = None  # (op, cnt)
        for g in range(min(int(totals[b]), capT)):
            tok = int(toks[b, g])
            tag, val = tok >> VAL_BITS, tok & VAL_MASK
            if tag == TAG_EXT:
                pend = (pend[0], pend[1] + val)
                continue
            if pend is not None:
                runs.append(pend)
                pend = None
            if tag == 0:
                runs.append((0, val))
            else:
                if val:
                    runs.append((0, val))
                pend = (tag, 1)
        if pend is not None:
            runs.append(pend)
        out.append(runs)
    return out
