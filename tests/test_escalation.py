"""tb_cap escalation ladder: tb-failed lanes re-run on the window kernel
(interpret mode here) at doubled caps before the full-K XLA fallback
(api._escalate_tb_cap).
Output-invariant vs the scalar oracle; exercised with a deliberately tiny
tb_cap_override so realistic error rates overflow it."""

import numpy as np
import pytest

from scrooge_tpu import api
from scrooge_tpu.config import AlignConfig


def _noisy_pairs(n=12, tlen=260, rate=0.18, seed=3):
    rng = np.random.default_rng(seed)
    bases = "ACGT"
    texts, queries = [], []
    for _ in range(n):
        t = "".join(rng.choice(list(bases)) for _ in range(tlen))
        q = []
        for c in t[:200]:
            r = rng.random()
            if r < rate * 0.6:
                q.append(bases[(bases.index(c) + 1) % 4])
            elif r < rate * 0.8:
                q.append(c + bases[int(rng.integers(4))])
            elif r < rate:
                continue
            else:
                q.append(c)
        texts.append(t)
        queries.append("".join(q))
    return texts, queries


@pytest.fixture(scope="module")
def noisy():
    texts, queries = _noisy_pairs()
    oracle = api.align_pairs(texts, queries,
                             AlignConfig(W=64, K=64, O=33, backend="pyref"))
    return texts, queries, oracle


def test_escalation_resolves_tb_failures(noisy):
    texts, queries, oracle = noisy
    cfg = AlignConfig(W=64, K=64, O=33, backend="pallas", batch_tile=128,
                      tb_cap_override=4, interpret=True)
    alns, stats = api.align_pairs(texts, queries, cfg, return_stats=True)
    # at cap=4 these error rates must overflow some windows...
    assert stats.retried_pairs > 0
    # ...and the ladder must resolve them on the kernel, not XLA
    assert stats.escalated_pairs > 0
    assert stats.engine_tiles["escalation"] > 0
    for a, o in zip(alns, oracle):
        assert (a.edit_distance, a.cigar) == (o.edit_distance, o.cigar)


def test_escalation_off_matches(noisy):
    texts, queries, oracle = noisy
    cfg = AlignConfig(W=64, K=64, O=33, backend="pallas", batch_tile=128,
                      tb_cap_override=4, retry_escalation=False,
                      interpret=True)
    alns, stats = api.align_pairs(texts, queries, cfg, return_stats=True)
    assert stats.retried_pairs > 0 and stats.escalated_pairs == 0
    for a, o in zip(alns, oracle):
        assert (a.edit_distance, a.cigar) == (o.edit_distance, o.cigar)


def test_escalation_packed(noisy):
    texts, queries, oracle = noisy
    cfg = AlignConfig(W=64, K=64, O=33, backend="pallas", batch_tile=128,
                      tb_cap_override=4, interpret=True)
    packed = api.align_pairs(texts, queries, cfg, return_packed=True)
    for i, o in enumerate(oracle):
        assert int(packed.edit_distances[i]) == o.edit_distance
        assert packed.cigar(i) == o.cigar


def _drifting_pairs(n=8, tlen=420, seed=11):
    """Half the lanes align cleanly (diagonal paths), half are
    deletion-rich (their pattern cursor falls ~6 chars behind per
    window): the cursors of the two groups drift further apart with
    every window."""
    rng = np.random.default_rng(seed)
    bases = "ACGT"
    texts, queries = [], []
    for i in range(n):
        t = "".join(rng.choice(list(bases)) for _ in range(tlen))
        if i % 2 == 0:
            q = t[: tlen - 40]
        else:
            keep = rng.random(tlen - 40) >= 0.2  # 20% deletions
            q = "".join(c for c, k in zip(t[: tlen - 40], keep) if k)
        texts.append(t)
        queries.append(q)
    return texts, queries


def test_escalation_resolves_drift_failures():
    """Cursor drift is no failure at all: every lane reads its own words
    at its own cursor, so drifting lanes need no retry and stay exact.
    (tb_cap = K, so that the deletion-rich windows cannot fail for depth
    either.)"""
    texts, queries = _drifting_pairs()
    oracle = api.align_pairs(texts, queries,
                             AlignConfig(W=64, K=64, O=33, backend="pyref"))
    cfg = AlignConfig(W=64, K=64, O=33, backend="pallas", batch_tile=128,
                      tb_cap_override=64, interpret=True)
    api._cap_cache.clear()  # caps predicted by other tests' pairs
    alns, stats = api.align_pairs(texts, queries, cfg, return_stats=True)
    assert stats.retried_pairs == 0
    assert stats.engine_tiles == {"pallas": 1}
    for a, o in zip(alns, oracle):
        assert (a.edit_distance, a.cigar) == (o.edit_distance, o.cigar)
