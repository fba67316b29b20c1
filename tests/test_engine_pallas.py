"""Pallas window-kernel tests.

The kernel must be bit-identical to the XLA engine (and hence the scalar
oracle / reference semantics). Here it runs in Pallas interpret mode,
asked for explicitly with AlignConfig(interpret=True) — same kernel code,
same outputs, slower, so the cases stay small. Compilation for the GPU is
checked by lowering the kernel through the Triton route for the CUDA
platform; running it compiled is chip_smoke.py's job (and the
gpu-marked test below).
"""

import os
import random

import jax.numpy as jnp
import numpy as np
import pytest

import scrooge_tpu
from scrooge_tpu import AlignConfig
from scrooge_tpu import pyref
from scrooge_tpu.config import AlignConfig as _AC
from scrooge_tpu.ops import engine_pallas, engine_xla

PL_CFG = AlignConfig(backend="pallas", batch_tile=128, interpret=True)


def _random_cases(seed, count, max_len=180):
    rng = random.Random(seed)
    cases = []
    while len(cases) < count:
        n = rng.randint(1, max_len)
        t = "".join(rng.choice("ACGT") for _ in range(n))
        q = []
        for c in t:
            r = rng.random()
            if r < 0.03:
                continue
            if r < 0.06:
                q.append(rng.choice("ACGT"))
            q.append(c)
        q = "".join(q)
        if q:
            cases.append((t, q))
    return cases


def test_pallas_engine_matches_xla_engine_raw():
    """Raw engine-to-engine equality on every output array."""
    cfg = _AC(W=32, K=32, O=17, interpret=True)
    B = 128
    rng = np.random.default_rng(5)
    T, P = 64, 48
    text = rng.integers(0, 4, (B, T), dtype=np.uint8)
    pattern = np.where(
        rng.random((B, P)) < 0.1,
        rng.integers(0, 4, (B, P), dtype=np.uint8),
        text[:, :P]).astype(np.uint8)
    tlen = rng.integers(1, T + 1, B).astype(np.int32)
    plen = rng.integers(0, P + 1, B).astype(np.int32)
    maxw = cfg.max_windows(P)

    rp = engine_pallas.align_batch(
        cfg, maxw,
        engine_pallas.pack_2bit_host(text), tlen,
        engine_pallas.pack_2bit_host(pattern), plen)
    rx = engine_xla.align_batch(cfg, maxw, text, tlen, pattern, plen)
    np.testing.assert_array_equal(np.asarray(rp.edit_distance),
                                  np.asarray(rx.edit_distance))
    np.testing.assert_array_equal(np.asarray(rp.failed) != 0,
                                  np.asarray(rx.failed))
    assert rp.counts.shape == rx.counts.shape  # exactly max_windows
    np.testing.assert_array_equal(np.asarray(rp.counts),
                                  np.asarray(rx.counts))
    # entry layouts differ (pallas: sparse maximal-run rows; xla: dense
    # slots) — compare the per-pair run lists after device compaction,
    # which also pins compact_entries_sparse against the dense compactor
    cap = int(np.asarray(rx.counts).sum(axis=0).max()) + 2
    cp, tp = engine_pallas.compact_entries_sparse(rp.entries, rp.counts, cap)
    cx, tx = engine_xla.compact_entries(rx.entries, rx.counts, cap)
    np.testing.assert_array_equal(np.asarray(tp), np.asarray(tx))
    np.testing.assert_array_equal(np.asarray(cp), np.asarray(cx))


def test_pallas_api_matches_oracle():
    cases = _random_cases(17, 32)
    cases.append(("ACGT" * 40, ""))  # empty read lane
    cases.append(("ACGT", "ACGTACGT" * 6))  # text exhausted
    texts = [t for t, _ in cases]
    queries = [q for _, q in cases]
    got = scrooge_tpu.align_all(texts, queries, config=PL_CFG)
    for (t, q), a in zip(cases, got):
        ed, cigar = pyref.align_pair(t, q, AlignConfig())
        assert a.edit_distance == ed
        assert a.cigar == cigar


@pytest.mark.parametrize("wko", [(16, 16, 9), (64, 64, 33), (128, 128, 65)])
def test_pallas_other_configs(wko):
    W, K, O = wko
    cfg = AlignConfig(W=W, K=K, O=O, backend="pallas", batch_tile=128,
                      interpret=True)
    cases = _random_cases(29, 12, max_len=120)
    texts = [t for t, _ in cases]
    queries = [q for _, q in cases]
    got = scrooge_tpu.align_all(texts, queries, config=cfg)
    ref_cfg = AlignConfig(W=W, K=K, O=O)
    for (t, q), a in zip(cases, got):
        ed, cigar = pyref.align_pair(t, q, ref_cfg)
        assert a.edit_distance == ed
        assert a.cigar == cigar


def test_pallas_long_reads_no_spurious_failures():
    """Multi-window reads must not fail lanes on the device path. A
    failed lane silently falls back to the bit-exact scalar retry, so
    parity tests cannot catch a fail storm — only the raw engine flags
    can."""
    cfg = _AC(W=64, K=64, O=33, interpret=True)
    B, rl, tl = 256, 600, 680
    rng = np.random.default_rng(9)
    text = rng.integers(0, 4, (B, tl), dtype=np.uint8)
    pattern = np.where(
        rng.random((B, rl)) < 0.05,
        rng.integers(0, 4, (B, rl), dtype=np.uint8),
        text[:, :rl]).astype(np.uint8)
    tlen = np.full(B, tl, np.int32)
    plen = np.full(B, rl, np.int32)
    maxw = cfg.max_windows(rl)
    rp = engine_pallas.align_batch(
        cfg, maxw,
        engine_pallas.pack_2bit_host(text), tlen,
        engine_pallas.pack_2bit_host(pattern), plen)
    rx = engine_xla.align_batch(cfg, maxw, text, tlen, pattern, plen)
    assert int(np.asarray(rp.failed).sum()) == 0
    np.testing.assert_array_equal(np.asarray(rp.edit_distance),
                                  np.asarray(rx.edit_distance))


def test_garbage_candidates_batched_retry():
    """Wrong seed locations (real read-mapping inputs contain them en
    masse) push per-window edit distances past the kernel's tb_cap; those
    lanes must route through the BATCHED full-K XLA retry — not the
    ~1000x-slower scalar path — and still return bit-exact results."""
    import scrooge_tpu.api as api
    from scrooge_tpu.datamodel import CandidateLocation, Genome, Read

    rng = random.Random(41)
    genome = "".join(rng.choice("ACGT") for _ in range(4000))
    reads = []
    for i in range(24):
        start = rng.randint(0, 3000)
        seg = genome[start : start + 160]
        read = "".join(c for c in seg if rng.random() > 0.04)
        # half the candidates are garbage: a random unrelated location
        loc = start if i % 2 == 0 else (start + 1700) % 3000
        reads.append(Read(description=f"r{i}", content=read,
                          locations=[CandidateLocation(
                              start_in_reference=loc)]))
    cfg = AlignConfig(backend="pallas", batch_tile=128, interpret=True)
    got, stats = api.align_reads(Genome(content=genome), reads, cfg,
                                 return_stats=True)
    assert stats.retried_pairs > 0  # the garbage half did fail the kernel
    assert stats.engine_tiles["pallas"] == 1
    ref_cfg = AlignConfig()
    for read, a in zip(reads, got):
        start = read.locations[0].start_in_reference
        ed, cigar = pyref.align_pair(genome[start:], read.content, ref_cfg)
        assert a.edit_distance == ed
        assert a.cigar == cigar


def test_single_laggard_does_not_fail_batch():
    """Pairs at distant cursors stay exact: one insertion-dominated lane
    (an unrelated read whose text cursor crawls) shares its warp with a
    97%-match pack. Every lane reads its own text at its own cursor, so
    no lane of the pack may fail, and all of them must equal engine_xla."""
    cfg = _AC(W=64, K=64, O=33, interpret=True)
    B, rl = 128, 600
    rng = np.random.default_rng(13)
    text = rng.integers(0, 4, (B, rl + 80), dtype=np.uint8)
    pattern = np.where(
        rng.random((B, rl)) < 0.03,
        rng.integers(0, 4, (B, rl), dtype=np.uint8),
        text[:, :rl]).astype(np.uint8)
    # lane 0: unrelated random read — consumes text far slower than the
    # 97%-match pack once windows stop matching cleanly
    pattern[0] = rng.integers(0, 4, rl, dtype=np.uint8)
    tlen = np.full(B, rl + 80, np.int32)
    plen = np.full(B, rl, np.int32)
    maxw = cfg.max_windows(rl)
    rp = engine_pallas.align_batch(
        cfg, maxw,
        engine_pallas.pack_2bit_host(text), tlen,
        engine_pallas.pack_2bit_host(pattern), plen)
    rx = engine_xla.align_batch(cfg, maxw, text, tlen, pattern, plen)
    failed = np.asarray(rp.failed)
    assert int(failed[1:].sum()) == 0
    np.testing.assert_array_equal(np.asarray(rp.edit_distance)[1:],
                                  np.asarray(rx.edit_distance)[1:])


@pytest.mark.parametrize("W", [16, 32, 40, 64, 128, 192, 256, 512])
def test_kernel_shape_choice(W):
    """The shape chooser gives every W up to the kernel's widest one
    warp-sized blocks and the four-row fill band, and no kernel
    (engine_xla) past W=256; the R buffer holds every traced row."""
    cfg = _AC(W=W, K=W, O=W // 2 + 1)
    bl, band = engine_pallas.choose_kernel_shape(cfg)
    if W > 256:
        assert (bl, band) == (0, 0)
        return
    assert bl == engine_pallas.PAIRS_PER_BLOCK and bl % 32 == 0
    assert band == engine_pallas.FILL_BAND == 4
    assert engine_pallas.r_rows(cfg, band) >= cfg.tb_cap + 1
    # the d-search advances whole bands: its last band may overhang
    # tb_cap, and every row it writes has a slot
    last_band_start = (cfg.tb_cap // band) * band
    assert last_band_start + band <= engine_pallas.r_rows(cfg, band)


def test_kernel_pads_batch_to_whole_blocks():
    """A batch that is not a whole number of 32-pair blocks is padded
    with empty lanes inside the engine and sliced back: the real lanes'
    results equal engine_xla's, and the outputs keep the caller's batch
    size."""
    cfg = _AC(W=32, K=32, O=17, interpret=True)
    B, n = 128, 40
    rng = np.random.default_rng(8)
    text = rng.integers(0, 4, (B, 96), dtype=np.uint8)
    pattern = np.where(rng.random((B, 80)) < 0.06,
                       rng.integers(0, 4, (B, 80), dtype=np.uint8),
                       text[:, :80]).astype(np.uint8)
    tlen = np.full(B, 96, np.int32)
    plen = np.full(B, 80, np.int32)
    tlen[n:] = 0
    plen[n:] = 0
    maxw = cfg.max_windows(80)
    rp = engine_pallas.align_batch(
        cfg, maxw, engine_pallas.pack_2bit_host(text[:n]), tlen[:n],
        engine_pallas.pack_2bit_host(pattern[:n]), plen[:n])
    rx = engine_xla.align_batch(cfg, maxw, text, tlen, pattern, plen)
    assert rp.edit_distance.shape == (n,)
    assert rp.entries.shape[-1] == n and rp.counts.shape == (maxw, n)
    np.testing.assert_array_equal(np.asarray(rp.edit_distance),
                                  np.asarray(rx.edit_distance)[:n])
    np.testing.assert_array_equal(np.asarray(rp.counts),
                                  np.asarray(rx.counts)[:, :n])


def test_resolve_backend_by_platform(monkeypatch):
    """"auto" runs the kernel on a GPU and engine_xla on the CPU; a W
    whose state the kernel does not take runs on engine_xla even on a
    GPU; "xla" is never overridden."""
    import jax

    from scrooge_tpu.api import _resolve_backend

    assert _resolve_backend(_AC()) == "xla"  # this process: the CPU
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert _resolve_backend(_AC()) == "pallas"
    assert _resolve_backend(_AC(W=512, K=512, O=257)) == "xla"
    assert _resolve_backend(_AC(backend="xla")) == "xla"
    assert _resolve_backend(_AC(backend="pallas")) == "pallas"
    with pytest.raises(ValueError, match="register state"):
        _resolve_backend(_AC(W=512, K=512, O=257, backend="pallas"))


def test_pallas_backend_raises_without_gpu():
    """backend="pallas" never falls back silently: without a GPU it
    raises unless interpret mode is asked for, at the API and at the
    engine."""
    with pytest.raises(RuntimeError, match="needs a GPU"):
        scrooge_tpu.align_all(["ACGTACGT"], ["ACGTACGT"],
                              config=AlignConfig(backend="pallas"))
    words = engine_pallas.pack_2bit_host(np.zeros((128, 16), np.uint8))
    lens = np.full(128, 16, np.int32)
    with pytest.raises(RuntimeError, match="needs a GPU"):
        engine_pallas.align_batch(_AC(), 4, words, lens, words, lens)
    got = scrooge_tpu.align_all(
        ["ACGTACGT"], ["ACGTACGT"],
        config=AlignConfig(backend="pallas", interpret=True))
    assert (got[0].edit_distance, got[0].cigar) == (0, "8=")


@pytest.mark.parametrize("wo", [(16, 9), (40, 21), (64, 33), (256, 129)])
def test_kernel_lowers_through_triton_for_cuda(wo, monkeypatch):
    """Every primitive of the kernel has a Triton lowering: the kernel is
    lowered for the CUDA platform here, on the CPU, so an unsupported
    operation fails in the tests rather than first on the card. (The
    GPU's own compiler runs only there; chip_smoke.py compiles and checks
    these widths.)"""
    import jax

    W, O = wo
    cfg = _AC(W=W, K=W, O=O)
    monkeypatch.setattr(engine_pallas, "check_device", lambda cfg: None)
    B, P = 256, 640
    args = (jax.ShapeDtypeStruct((4096,), jnp.uint32),
            jax.ShapeDtypeStruct((B,), jnp.uint32),
            jax.ShapeDtypeStruct((B,), jnp.int32),
            jax.ShapeDtypeStruct((B, P // 16), jnp.uint32),
            jax.ShapeDtypeStruct((B,), jnp.int32))
    lowered = jax.jit(
        lambda *a: engine_pallas.align_batch_mapped(cfg, 32, *a)
    ).trace(*args).lower(lowering_platforms=("cuda",))
    text = lowered.as_text()
    assert "__gpu$xla.gpu.triton" in text
    assert "genasm_windows" in text


@pytest.mark.gpu
def test_kernel_matches_xla_on_gpu(gpu):
    """On the card: the compiled kernel equals engine_xla on 512 random
    pairs at the headline config (chip_smoke.py runs the full set)."""
    cfg = _AC(W=64, K=64, O=33)
    B, rl = 512, 900
    rng = np.random.default_rng(4)
    text = rng.integers(0, 4, (B, rl + 100), dtype=np.uint8)
    pattern = np.where(rng.random((B, rl)) < 0.05,
                       rng.integers(0, 4, (B, rl), dtype=np.uint8),
                       text[:, :rl]).astype(np.uint8)
    tlen = np.full(B, rl + 100, np.int32)
    plen = np.full(B, rl, np.int32)
    maxw = cfg.max_windows(rl)
    rp = engine_pallas.align_batch(
        cfg, maxw, engine_pallas.pack_2bit_host(text), tlen,
        engine_pallas.pack_2bit_host(pattern), plen)
    rx = engine_xla.align_batch(cfg, maxw, text, tlen, pattern, plen)
    ok = (np.asarray(rp.failed) == 0) & ~np.asarray(rx.failed)
    assert ok.sum() > B // 2
    np.testing.assert_array_equal(np.asarray(rp.edit_distance)[ok],
                                  np.asarray(rx.edit_distance)[ok])


def test_pack_rows_dense_matches_oracle():
    """Log-shift row compaction (engine_pallas._pack_rows_dense) must
    stable-compact every window's nonzero rows to a dense prefix; checked
    against a scalar numpy oracle over random sparsity patterns, including
    the all-valid and all-empty extremes."""
    rng = np.random.default_rng(21)
    for ne3 in (1, 2, 5, 17, 66):
        maxw, b = 7, 16
        density = rng.uniform(0, 1, (maxw, 1, b))
        ents = np.where(rng.uniform(size=(maxw, ne3, b)) < density,
                        rng.integers(1, 1 << 16, (maxw, ne3, b)),
                        0).astype(np.uint16)
        ents[0, :, 0] = 0          # all-empty window
        if ne3 > 2:
            ents[1, :, 1] = 7      # all-valid window
        got = np.asarray(engine_pallas._pack_rows_dense(jnp.asarray(ents)))
        for w in range(maxw):
            for lane in range(b):
                col = ents[w, :, lane]
                want = col[col != 0]
                assert np.array_equal(got[w, : len(want), lane], want), (
                    ne3, w, lane)


def test_failure_reason_telemetry():
    """The kernel's failed lanes carry a reason BITMASK
    (engine_pallas.FAIL_*) and AlignStats aggregates it — the telemetry
    analogue of the reference's DEBUG traceback checks
    (genasm_cpu.cpp:362-385). Garbage candidates overflow tb_cap, so the
    tb-depth counter must account for the retries."""
    import scrooge_tpu.api as api
    from scrooge_tpu.datamodel import CandidateLocation, Genome, Read

    rng = random.Random(43)
    genome = "".join(rng.choice("ACGT") for _ in range(4000))
    reads = []
    for i in range(16):
        start = rng.randint(0, 3000)
        seg = genome[start : start + 160]
        read = "".join(c for c in seg if rng.random() > 0.04)
        loc = start if i % 2 == 0 else (start + 1700) % 3000
        reads.append(Read(description=f"r{i}", content=read,
                          locations=[CandidateLocation(
                              start_in_reference=loc)]))
    cfg = AlignConfig(backend="pallas", batch_tile=128, interpret=True)
    # caps predicted by an earlier test of this config could fail a lane
    # for compaction overflow, which carries no kernel reason bit
    api._cap_cache.clear()
    _, stats = api.align_reads(Genome(content=genome), reads, cfg,
                               return_stats=True)
    assert stats.retried_pairs > 0
    reasons = (stats.fail_tb_pairs + stats.fail_stall_pairs
               + stats.fail_incomplete_pairs)
    # every failed lane sets at least one reason bit
    assert reasons >= stats.retried_pairs
    assert stats.fail_tb_pairs > 0  # garbage candidates exceed tb_cap
    assert "fail[tb=" in stats.breakdown()
    assert "engines[" in stats.breakdown() and "pallas=1" in stats.breakdown()


def test_pyref_debug_dead_end_detection(monkeypatch):
    """SCROOGE_DEBUG traceback guard (genasm_cpu.cpp:307-385): clean
    tables traceback identically with the guard on; a corrupted table
    (no zero anywhere) raises TracebackDeadEnd instead of emitting a
    bogus '=' run."""
    cfg = AlignConfig()
    cases = _random_cases(31, 10)
    plain = [pyref.align_pair(t, q, cfg) for t, q in cases]
    monkeypatch.setattr(pyref, "DEBUG", True)
    checked = [pyref.align_pair(t, q, cfg) for t, q in cases]
    assert plain == checked

    class _NoZeros:
        def zero_at(self, *a):
            return False

    with pytest.raises(pyref.TracebackDeadEnd):
        pyref.genasm_tb(4, 4, _NoZeros(), 2, cfg)


def test_single_leader_does_not_fail_batch():
    """Mirror of the laggard case: one CLEAN lane among an insertion-rich
    pack races ahead in text position. Pairs at distant cursors stay
    exact: nobody fails, and every lane equals engine_xla."""
    cfg = _AC(W=64, K=64, O=33, interpret=True)
    B, span = 128, 600
    rng = np.random.default_rng(17)
    text = rng.integers(0, 4, (B, span + 80), dtype=np.uint8)
    # pack: every text char kept, ~45% random insertions -> text cursor
    # advances ~21 chars/window instead of ~31
    pats = []
    for lane_i in range(B):
        src = text[lane_i, :span]
        reps = np.where(rng.random(span) < 0.45, 2, 1)
        p = np.repeat(src, reps)
        ins_pos = np.cumsum(reps) - 1
        ins_pos = ins_pos[reps == 2]
        p[ins_pos] = rng.integers(0, 4, len(ins_pos))
        pats.append(p)
    # lane 0: clean read over the same span -> advances ~31 chars/window
    pats[0] = text[0, :span].copy()
    P = max(len(p) for p in pats)
    pattern = np.zeros((B, P), np.uint8)
    plen = np.zeros(B, np.int32)
    for lane_i, p in enumerate(pats):
        pattern[lane_i, : len(p)] = p
        plen[lane_i] = len(p)
    tlen = np.full(B, span + 80, np.int32)
    maxw = cfg.max_windows(int(plen.max()))
    rp = engine_pallas.align_batch(
        cfg, maxw,
        engine_pallas.pack_2bit_host(text), tlen,
        engine_pallas.pack_2bit_host(pattern), plen)
    rx = engine_xla.align_batch(cfg, maxw, text, tlen, pattern, plen)
    failed = np.asarray(rp.failed)
    assert int((failed != 0).sum()) == 0, int((failed != 0).sum())
    np.testing.assert_array_equal(np.asarray(rp.edit_distance),
                                  np.asarray(rx.edit_distance))


@pytest.mark.skipif(not os.environ.get("SCROOGE_SLOW_TESTS"),
                    reason="~2.5 min interpreted; run with "
                           "SCROOGE_SLOW_TESTS=1 (validated this round: "
                           "equal=True, failed=0)")
def test_w256_parity_interpreted():
    """W=256 K=256 O=129 (the top of the reference's W-sweep range,
    profile.py:65-82) on the kernel in interpreter mode:
    bit-identical edit distances to the XLA engine, no failed lanes.
    GPU compilation of this config is checked by chip_smoke.py's width
    phase."""
    cfg = _AC(W=256, K=256, O=129, batch_tile=128, interpret=True)
    B, rl, tl = 128, 220, 320
    rng = np.random.default_rng(7)
    text = rng.integers(0, 4, (B, tl), dtype=np.uint8)
    pattern = np.where(rng.random((B, rl)) < 0.08,
                       rng.integers(0, 4, (B, rl), dtype=np.uint8),
                       text[:, :rl]).astype(np.uint8)
    tlen = np.full(B, tl, np.int32)
    plen = np.full(B, rl, np.int32)
    maxw = cfg.max_windows(rl)
    rp = engine_pallas.align_batch(
        cfg, maxw, engine_pallas.pack_2bit_host(text), tlen,
        engine_pallas.pack_2bit_host(pattern), plen)
    rx = engine_xla.align_batch(cfg, maxw, text, tlen, pattern, plen)
    assert not np.asarray(rp.failed).any()
    np.testing.assert_array_equal(np.asarray(rp.edit_distance),
                                  np.asarray(rx.edit_distance))


@pytest.mark.skipif(not os.environ.get("SCROOGE_SLOW_TESTS"),
                    reason="interpreted large-W run; run with "
                           "SCROOGE_SLOW_TESTS=1")
def test_w240_parity_interpreted():
    """W=240 K=240 O=121 (the one reference-grid W whose traceback bit
    range [O-1, W) straddles 5 words, profile.py:65-82) on the kernel in
    interpreter mode: bit-identical edit distances to the XLA engine on
    lanes the capped d-search resolves; over-cap lanes report FAIL_TB for
    the escalation ladder, exactly the api contract."""
    cfg = _AC(W=240, K=240, O=121, batch_tile=128, interpret=True)
    B, rl, tl = 128, 220, 320
    rng = np.random.default_rng(11)
    text = rng.integers(0, 4, (B, tl), dtype=np.uint8)
    pattern = np.where(rng.random((B, rl)) < 0.08,
                       rng.integers(0, 4, (B, rl), dtype=np.uint8),
                       text[:, :rl]).astype(np.uint8)
    tlen = np.full(B, tl, np.int32)
    plen = np.full(B, rl, np.int32)
    maxw = cfg.max_windows(rl)
    rp = engine_pallas.align_batch(
        cfg, maxw, engine_pallas.pack_2bit_host(text), tlen,
        engine_pallas.pack_2bit_host(pattern), plen)
    rx = engine_xla.align_batch(cfg, maxw, text, tlen, pattern, plen)
    failed = np.asarray(rp.failed)
    ok = failed == 0
    assert ok.any()
    np.testing.assert_array_equal(np.asarray(rp.edit_distance)[ok],
                                  np.asarray(rx.edit_distance)[ok])
    assert (failed[~ok] & engine_pallas.FAIL_TB).all() or ok.all()


def test_trailing_windows_beyond_max_windows_fail_like_xla():
    """The kernel runs exactly max_windows windows, like engine_xla:
    lanes that would need more FAIL, and entries/counts have exactly
    max_windows rows."""
    cfg = _AC(W=16, K=16, O=9, batch_tile=128, interpret=True)
    B, rl, tl = 128, 60, 90
    rng = np.random.default_rng(3)
    text = rng.integers(0, 4, (B, tl), dtype=np.uint8)
    pattern = np.where(rng.random((B, rl)) < 0.06,
                       rng.integers(0, 4, (B, rl), dtype=np.uint8),
                       text[:, :rl]).astype(np.uint8)
    pattern[:8, :] = rng.integers(0, 4, (8, rl), dtype=np.uint8)
    tlen = np.full(B, tl, np.int32)
    plen = np.full(B, rl, np.int32)
    tw = engine_pallas.pack_2bit_host(text)
    pw = engine_pallas.pack_2bit_host(pattern)
    for maxw in (9, 13):
        rp = engine_pallas.align_batch(cfg, maxw, tw, tlen, pw, plen)
        rx = engine_xla.align_batch(cfg, maxw, text, tlen, pattern, plen)
        assert rp.entries.shape[0] == maxw
        assert rp.counts.shape[0] == maxw
        fp = np.asarray(rp.failed) != 0
        fx = np.asarray(rx.failed)
        np.testing.assert_array_equal(fp, fx)
        ok = ~fp
        np.testing.assert_array_equal(
            np.asarray(rp.edit_distance)[ok],
            np.asarray(rx.edit_distance)[ok])


def test_compact_flat_logshift_matches_oracle():
    """Direct oracle test for engine_xla._compact_flat_logshift (the
    production compactor behind compact_entries[_sparse][_u8]): random
    valid masks, cap below/at/above L, and L around the 0xFFFF
    distance-dtype switch."""
    from scrooge_tpu.ops.engine_xla import _compact_flat_logshift

    rng = np.random.default_rng(33)
    cases = [(1, 8), (2, 8), (37, 16), (300, 8)]
    for L, B in cases:
        flat = rng.integers(0, 1 << 16, (L, B)).astype(np.uint16)
        valid = rng.uniform(size=(L, B)) < rng.uniform(0, 1, (1, B))
        valid[:, 0] = True   # fully valid lane
        valid[:, 1] = False  # fully empty lane
        for cap in {1, max(1, L // 2), L, L + 5}:
            out, totals = _compact_flat_logshift(
                jnp.asarray(flat), jnp.asarray(valid), cap)
            out, totals = np.asarray(out), np.asarray(totals)
            for b in range(B):
                want = flat[valid[:, b], b]
                assert totals[b] == len(want)
                keep = min(cap, len(want))
                assert np.array_equal(out[:keep, b], want[:keep]), (L, cap, b)
                assert (out[keep:, b] == 0).all()
    # dtype switch: L >= 0xFFFF must route distances through int32. One
    # case at the exact switch point (the uint16 path is already covered
    # by the small-L grid above; a second huge-L compile added ~100s of
    # suite time for no extra coverage)
    for L in (0xFFFF,):
        B = 2
        flat = rng.integers(1, 1 << 16, (L, B)).astype(np.uint16)
        valid = rng.uniform(size=(L, B)) < 0.001
        out, totals = _compact_flat_logshift(
            jnp.asarray(flat), jnp.asarray(valid), 64)
        out, totals = np.asarray(out), np.asarray(totals)
        for b in range(B):
            want = flat[valid[:, b], b][:64]
            assert totals[b] == valid[:, b].sum()
            assert np.array_equal(out[: len(want), b], want)


def test_pallas_emitter_counts_match_nonzero_slots():
    """Pin the invariant the sparse compactors rely on: the kernel's
    per-window ``counts`` equal the number of nonzero slots it
    wrote (compact_entries_sparse derives validity from slot != 0 and
    would silently disagree with the dense path if these diverged)."""
    cfg = _AC(W=64, K=64, O=33, batch_tile=128, interpret=True)
    rng = np.random.default_rng(5)
    B, rl, tl = 128, 700, 900
    text = rng.integers(0, 4, (B, tl), dtype=np.uint8)
    pattern = np.where(rng.uniform(size=(B, rl)) < 0.08,
                       rng.integers(0, 4, (B, rl), dtype=np.uint8),
                       text[:, :rl]).astype(np.uint8)
    tlen = np.full(B, tl, np.int32)
    plen = np.full(B, rl, np.int32)
    maxw = -(-cfg.max_windows(rl) // 32) * 32
    res = engine_pallas.align_batch(
        cfg, maxw,
        engine_pallas.pack_2bit_host(text), tlen,
        engine_pallas.pack_2bit_host(pattern), plen)
    # (maxw, ne3/2, B) pair-packed sparse rows: count nonzero halfwords
    packed = np.asarray(res.entries).astype(np.uint32)
    counts = np.asarray(res.counts)     # (maxw, B)
    nonzero = ((packed & 0xFFFF) != 0).sum(axis=1) \
        + ((packed >> 16) != 0).sum(axis=1)
    assert np.array_equal(counts, nonzero)
    assert counts.sum() > 0  # the invariant isn't vacuous
