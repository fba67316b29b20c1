"""Multiword bitvector primitives on uint32 lane arrays.

A bitvector of W bits is an array of shape (NW, *lane_shape) uint32, word 0
least-significant, with the top word masked to W % 32 bits (cf. the
reference's macro-generated fixed-width bitvector, bitvector.hpp:32-54;
here it is plain vectorized uint32 arithmetic over the lane grid).

The engine runs the DP in an MSB-aligned space: for a window of pattern
length m <= W, all quantities are the reference's values shifted left by
s = W - m, with the low s bits kept zero. Left shifts (the only shifts in
the recurrence) fill zeros from below exactly like the reference, so the
two spaces are bit-identical on the observed band; the payoff is that the
full-match probe is always bit W-1 and traceback reads bit W-1-j, with no
per-lane m anywhere in the hot loop.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
import numpy as np
from jax import lax

# numpy scalar, NOT jnp: a module-level jnp constant would initialize the
# XLA backend at import time, which breaks jax.distributed.initialize()
# for multi-process users (it must run before any backend touch)
UMAX = np.uint32(0xFFFFFFFF)


def shl_var(x: jnp.ndarray, amt: jnp.ndarray) -> jnp.ndarray:
    """uint32 << per-lane amount in [0, 31].

    Routed through int32: XLA CPU compiles unsigned variable shifts
    pathologically slowly (~30s per instance inside loops); int32 shifts
    are bit-identical for << and compile instantly.
    """
    xi = x.astype(jnp.int32) if x.dtype == jnp.uint32 else x
    return lax.shift_left(xi, amt.astype(jnp.int32)).astype(jnp.uint32)


def shr_var(x: jnp.ndarray, amt: jnp.ndarray) -> jnp.ndarray:
    """uint32 >> (logical) per-lane amount in [0, 31]; int32-routed."""
    xi = x.astype(jnp.int32) if x.dtype == jnp.uint32 else x
    return lax.shift_right_logical(xi, amt.astype(jnp.int32)).astype(jnp.uint32)


def num_words(W: int) -> int:
    return (W + 31) // 32


def top_mask(W: int) -> int:
    """Mask for the most-significant word."""
    rem = W % 32
    return 0xFFFFFFFF if rem == 0 else (1 << rem) - 1


def ones(W: int, lane_shape: Tuple[int, ...]) -> jnp.ndarray:
    nw = num_words(W)
    words = [jnp.full(lane_shape, 0xFFFFFFFF, jnp.uint32) for _ in range(nw)]
    words[-1] = jnp.full(lane_shape, top_mask(W), jnp.uint32)
    return jnp.stack(words)


def zeros(W: int, lane_shape: Tuple[int, ...]) -> jnp.ndarray:
    return jnp.zeros((num_words(W),) + lane_shape, jnp.uint32)


def shl1(v: jnp.ndarray, W: int) -> jnp.ndarray:
    """Shift left by one bit with cross-word carry; zero-fill at bit 0."""
    nw = v.shape[0]
    out = []
    for w in range(nw):
        word = v[w] << 1
        if w > 0:
            word = word | (v[w - 1] >> 31)
        out.append(word)
    out[-1] = out[-1] & jnp.uint32(top_mask(W))
    return jnp.stack(out)


def ones_shifted(shift: jnp.ndarray, W: int) -> jnp.ndarray:
    """ones(W) << shift, for any non-negative per-lane int32 ``shift``
    (callers reach W+K+2 via the wavefront fill's ones_table; the
    per-word clamp below makes every shift >= W yield zeros, so the
    domain is unbounded above).

    Word w holds bits [32w, 32w+32); bit b is 1 iff shift <= b < W.
    """
    nw = num_words(W)
    ones_full = jnp.broadcast_to(UMAX, shift.shape)
    out = []
    for w in range(nw):
        c = jnp.clip(shift - 32 * w, 0, 32)
        # clamp the shift operand to 31: XLA shift-by->=width is undefined
        word = jnp.where(c >= 32, jnp.uint32(0),
                         shl_var(ones_full, jnp.minimum(c, 31)))
        out.append(word.astype(jnp.uint32))
    out[-1] = out[-1] & jnp.uint32(top_mask(W))
    return jnp.stack(out)


def bit_is_zero(v: jnp.ndarray, bit: jnp.ndarray, first_word: int = 0) -> jnp.ndarray:
    """True where bit ``bit`` (per-lane int32, global bit index) of v is 0.

    ``v`` holds words [first_word, first_word + v.shape[0]) of the full
    vector (supports traceback-truncated storage).
    """
    word_idx = bit >> 5
    off = bit & 31
    acc = jnp.zeros(v.shape[1:], jnp.uint32)
    for w in range(v.shape[0]):
        sel = word_idx == (w + first_word)
        acc = acc | jnp.where(sel, shr_var(v[w], off) & jnp.uint32(1),
                              jnp.uint32(0))
    return acc == 0
