#!/usr/bin/env python3
"""Smoke run of the read-mapping main path on NVIDIA GPUs.

    python chip_smoke.py               # one card: phases 1-6 below
    python chip_smoke.py --four-cards  # the pairs mesh over 4 cards only

One process holds the card(s) through every phase:

1. device   — the JAX device must be a GPU; prints its kind and count and
              the card's name and power limit (nvidia-smi, in a child).
2. headline — bench.py's deployment: 32,768 simulated 10 kbp reads at 95%
              accuracy against a 1 Mbase genome, W=64 K=64 O=33, tiles of
              16,384 pairs, through scrooge_tpu.align_all with
              backend="auto". Exactness: 512 pairs against backend="xla"
              on the card, 8 against the scalar oracle (backend="pyref").
3. short    — 32,768 reads of 150 bp at W=32 O=17, the same checks.
4. retry    — 2,048 reads of 10 kbp at 85% accuracy with a small tb_cap,
              through the kernel's escalation ladder and, with the ladder
              off, through the full-K XLA retry; all equal backend="xla".
5. widths   — 1,024 random pairs per W in {16, 32, 40, 64, 128, 256}
              through the compiled kernel and engine_xla: zero
              differences on every pair the kernel answers.
6. timing   — the kernel alone against engine_xla alone on the same
              staged headline pairs (steady state, median of 3).

With --four-cards the script runs only the headline deployment on the
4-card pairs mesh and compares it bit for bit with one card.

Any failed check raises, and the script exits non-zero without printing
its result line. The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
# persistent compile cache: JAX_COMPILATION_CACHE_DIR when set, otherwise
# a fixed directory in the checkout (set before jax is imported)
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR",
                      os.path.join(_HERE, ".jax_cache"))

import numpy as np  # noqa: E402


def card_info() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` — a child process that
    stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return "; ".join(line.strip() for line in out.splitlines()
                     if line.strip())


def log(msg: str) -> None:
    print(msg, flush=True)


def same_alignments(label, got, want, idx=None):
    """Every got[i] equals want[k] (edit distance and CIGAR), where i =
    idx[k] (or k). Raises on the first difference."""
    idx = range(len(want)) if idx is None else idx
    for k, i in enumerate(idx):
        g, w = got[i], want[k]
        if (g.edit_distance, g.cigar) != (w.edit_distance, w.cigar):
            raise AssertionError(
                f"{label}: pair {i} differs: ed {g.edit_distance} vs "
                f"{w.edit_distance}, cigar {g.cigar[:60]} vs "
                f"{w.cigar[:60]}")
    log(f"  {label}: {len(want)} pairs identical")


def run_reads(genome, reads, cfg, label, card):
    """Warm up (compile), then one timed align_all; returns (alignments,
    stats, wall seconds). Prints the engine that ran, retries and the
    smoke rate."""
    from scrooge_tpu import align_all

    t0 = time.perf_counter()
    align_all(genome, reads, config=cfg)
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    alns, stats = align_all(genome, reads, config=cfg, return_stats=True)
    wall = time.perf_counter() - t0
    log(f"  {label}: engines {stats.engine_tiles} retried="
        f"{stats.retried_pairs} escalated={stats.escalated_pairs}")
    log(f"  {label}: smoke figure, not a benchmark: {len(alns)} pairs in "
        f"{wall:.3f} s = {len(alns) / wall:.1f} aligns/s end to end "
        f"(first call with compilation {warm:.1f} s) on {card}")
    log(f"  {label}: {stats.breakdown()}")
    return alns, stats, wall


def check_against_xla_and_oracle(genome, reads, alns, cfg, label,
                                 n_xla=512, n_oracle=8):
    from scrooge_tpu import align_all

    idx = np.linspace(0, len(reads) - 1, n_xla).astype(int)
    sub = [reads[i] for i in idx]
    xla = align_all(genome, sub, config=dataclasses.replace(
        cfg, backend="xla", batch_tile=n_xla))
    same_alignments(f"{label} vs backend=xla", alns, xla, idx)
    idx8 = idx[:: max(1, n_xla // n_oracle)][:n_oracle]
    oracle = align_all(genome, [reads[i] for i in idx8],
                       config=dataclasses.replace(cfg, backend="pyref"))
    same_alignments(f"{label} vs pyref", alns, oracle, idx8)


def phase_headline(card, n_reads=32_768, read_len=10_000, tile=16_384):
    from scrooge_tpu import AlignConfig
    from scrooge_tpu.utils.simulate import simulate_dataset

    ds = simulate_dataset(genome_len=1_000_000, num_reads=n_reads,
                          read_len=read_len, accuracy=0.95, seed=7)
    cfg = AlignConfig(W=64, K=64, O=33, batch_tile=tile)
    alns, stats, _ = run_reads(ds.genome, ds.reads, cfg, "headline", card)
    if set(stats.engine_tiles) - {"escalation", "retry_xla", "pyref"} \
            != {"pallas"}:
        raise AssertionError(f"headline ran on {stats.engine_tiles}")
    check_against_xla_and_oracle(ds.genome, ds.reads, alns, cfg, "headline")
    return ds, cfg


def phase_short(card, n_reads=32_768, tile=16_384):
    from scrooge_tpu import AlignConfig
    from scrooge_tpu.utils.simulate import simulate_dataset

    ds = simulate_dataset(genome_len=1_000_000, num_reads=n_reads,
                          read_len=150, accuracy=0.95, seed=7)
    cfg = AlignConfig(W=32, K=32, O=17, batch_tile=tile)
    alns, stats, _ = run_reads(ds.genome, ds.reads, cfg, "short", card)
    if set(stats.engine_tiles) - {"escalation", "retry_xla", "pyref"} \
            != {"pallas"}:
        raise AssertionError(f"short reads ran on {stats.engine_tiles}")
    check_against_xla_and_oracle(ds.genome, ds.reads, alns, cfg, "short")


def phase_retry(n_reads=2_048):
    from scrooge_tpu import AlignConfig, align_all
    from scrooge_tpu.utils.simulate import simulate_dataset

    ds = simulate_dataset(genome_len=1_000_000, num_reads=n_reads,
                          read_len=10_000, accuracy=0.85, seed=7)
    base = AlignConfig(W=64, K=64, O=33, batch_tile=n_reads)
    want = align_all(ds.genome, ds.reads,
                     config=dataclasses.replace(base, backend="xla"))
    for label, cfg, route in (
            ("ladder", dataclasses.replace(base, tb_cap_override=8),
             "escalation"),
            ("full-K XLA retry", dataclasses.replace(
                base, tb_cap_override=8, retry_escalation=False),
             "retry_xla")):
        got, stats = align_all(ds.genome, ds.reads, config=cfg,
                               return_stats=True)
        log(f"  retry/{label}: retried={stats.retried_pairs} "
            f"escalated={stats.escalated_pairs} engines "
            f"{stats.engine_tiles}")
        if not stats.retried_pairs or route not in stats.engine_tiles:
            raise AssertionError(f"{label}: the retry path did not run")
        same_alignments(f"retry/{label} vs backend=xla", got, want)


def phase_widths(n_pairs=1_024, read_len=800):
    import jax

    from scrooge_tpu import AlignConfig
    from scrooge_tpu.ops import engine_pallas as ep, engine_xla as ex

    rng = np.random.default_rng(3)
    tl = read_len + 100
    text = rng.integers(0, 4, (n_pairs, tl), dtype=np.uint8)
    pattern = text[:, :read_len].copy()
    # 5% errors: substitutions, and shifted runs for indels
    sub = rng.random((n_pairs, read_len)) < 0.03
    pattern[sub] = rng.integers(0, 4, int(sub.sum()), dtype=np.uint8)
    for lane in range(n_pairs):
        for pos in rng.integers(1, read_len - 1, 6):
            if rng.random() < 0.5:
                pattern[lane, pos:] = np.roll(pattern[lane, pos:], 1)
            else:
                pattern[lane, pos:-1] = pattern[lane, pos + 1:]
    tlen = rng.integers(read_len // 2, tl + 1, n_pairs).astype(np.int32)
    plen = rng.integers(read_len // 2, read_len + 1,
                        n_pairs).astype(np.int32)
    tw, pw = ep.pack_2bit_host(text), ep.pack_2bit_host(pattern)
    for W in (16, 32, 40, 64, 128, 256):
        cfg = AlignConfig(W=W, K=W, O=W // 2 + 1)
        maxw = cfg.max_windows(read_len)
        t0 = time.perf_counter()
        rp = jax.device_get(ep.align_batch(cfg, maxw, tw, tlen, pw, plen))
        tk = time.perf_counter() - t0
        rx = jax.device_get(ex.align_batch(cfg, maxw, text, tlen, pattern,
                                           plen))
        reasons = np.asarray(rp.failed)
        kf = reasons != 0
        xf = np.asarray(rx.failed)
        # the kernel may fail more lanes than engine_xla only for depth
        # (tb_cap < K); every lane engine_xla fails, the kernel fails too
        if (reasons[kf & ~xf] != ep.FAIL_TB).any() or (xf & ~kf).any():
            raise AssertionError(f"W={W}: failure sets disagree")
        ok = ~kf
        cap = int(np.asarray(rx.counts).sum(axis=0).max()) + 2
        cp, tp = jax.device_get(ep.compact_entries_sparse(
            rp.entries, rp.counts, cap))
        cx, txt = jax.device_get(ex.compact_entries(rx.entries, rx.counts,
                                                    cap))
        diffs = int((np.asarray(rp.edit_distance)[ok]
                     != np.asarray(rx.edit_distance)[ok]).sum()
                    + (np.asarray(tp)[ok] != np.asarray(txt)[ok]).sum()
                    + (np.asarray(cp)[:, ok] != np.asarray(cx)[:, ok]).any(
                        axis=0).sum())
        log(f"  W={W} O={cfg.O}: {int(ok.sum())}/{n_pairs} pairs answered "
            f"by the kernel ({int(kf.sum())} over tb_cap, retried by the "
            f"api), differences vs engine_xla: {diffs} (kernel call with "
            f"compilation {tk:.1f} s)")
        if diffs:
            raise AssertionError(f"W={W}: {diffs} differences")


def phase_timing(ds, cfg, card, xla_budget_s=120.0):
    import jax

    from scrooge_tpu.ops import engine_pallas
    from scrooge_tpu.profiling import kernel_time as kt

    st = kt.stage_mapped(ds.genome.content, ds.reads, cfg)
    compiled = jax.jit(
        lambda *a: engine_pallas.align_batch_mapped(cfg, st.max_windows, *a)
    ).lower(*st.kernel_args).compile()
    log(f"  kernel step memory_analysis: {compiled.memory_analysis()}")
    t0 = time.perf_counter()
    jax.block_until_ready(kt.run_engine(st, "xla"))
    first = time.perf_counter() - t0
    if first > xla_budget_s:
        log(f"  engine_xla took {first:.1f} s for its first call at "
            f"{st.num_pairs} pairs: both engines are timed at 2,048 pairs")
        st = kt.stage_mapped(ds.genome.content, ds.reads,
                             dataclasses.replace(cfg, batch_tile=2_048))
    rates = {}
    for engine in ("pallas", "xla"):
        secs = sorted(kt.engine_seconds(st, engine, reps=3))
        med = secs[1]
        rates[engine] = st.num_pairs / med
        log(f"  {engine}: {st.num_pairs} pairs, engine-only seconds "
            f"{[round(s, 6) for s in secs]}, median {med:.6f} s = "
            f"{rates[engine]:.1f} aligns/s on {card}")
    log(f"  kernel / engine_xla: {rates['pallas'] / rates['xla']:.1f}x")


def four_cards(card, n_reads=32_768, read_len=10_000, tile=16_384):
    from unittest import mock

    import jax

    from scrooge_tpu import AlignConfig, api
    from scrooge_tpu.ops import engine_pallas
    from scrooge_tpu.parallel import mesh as mesh_mod
    from scrooge_tpu.utils.simulate import simulate_dataset

    n = len(jax.devices())
    if n != 4:
        raise AssertionError(f"--four-cards needs 4 GPUs, found {n}")
    ds = simulate_dataset(genome_len=1_000_000, num_reads=n_reads,
                          read_len=read_len, accuracy=0.95, seed=7)
    cfg = AlignConfig(W=64, K=64, O=33, batch_tile=tile)
    mesh = api._resolve_mesh(cfg)
    if mesh is None or mesh.devices.size != 4:
        raise AssertionError("align_reads would not shard over 4 cards")
    genome_dev, _ = api.prepare_genome(ds.genome).device_genome("pallas",
                                                                mesh)
    if not (genome_dev.sharding.is_fully_replicated
            and len(genome_dev.sharding.device_set) == 4):
        raise AssertionError("the genome is not replicated to every card")
    log(f"  genome replicated on {len(genome_dev.sharding.device_set)} "
        "cards")
    reads = ds.reads[: min(2_048, tile)]
    lens = np.array([len(r.content) for r in reads], np.int32)
    codes = np.zeros((len(reads), api._bucket_lin(int(lens.max()), 1024)),
                     np.uint8)
    for lane, r in enumerate(reads):
        codes[lane, : lens[lane]] = api.encode_np(r.content)
    starts = np.array([r.locations[0].start_in_reference for r in reads],
                      np.int64)
    maxw = cfg.max_windows(int(lens.max()))
    tlen = np.minimum(len(ds.genome.content) - starts,
                      maxw * cfg.tb_limit + cfg.W).astype(np.int32)
    res = mesh_mod.pallas_align_mapped_on_mesh(
        cfg, maxw, mesh, genome_dev, starts.astype(np.uint32), tlen,
        engine_pallas.pack_2bit_host(codes), lens)
    shards = res.edit_distance.addressable_shards
    per_dev = {s.device.id: s.data.shape[0] for s in shards}
    if len(per_dev) != 4 or set(per_dev.values()) != {len(reads) // 4}:
        raise AssertionError(f"pair shards per card: {per_dev}")
    log(f"  pair shards per card: {per_dev}")

    def on_one_card():
        return mock.patch.object(api, "_resolve_mesh", lambda cfg: None)

    # order 4, 1, 1, 4 in one process: a drift that is linear in time
    # cancels out of the sums of the two 4-card and two 1-card walls
    alns, stats, wall = run_reads(ds.genome, ds.reads, cfg, "4 cards",
                                  card)
    log(f"  4 cards: {len(alns) / wall / n:.1f} aligns/s per card end to "
        f"end (smoke figure) on {card}")
    if set(stats.engine_tiles) - {"escalation", "retry_xla", "pyref"} \
            != {"pallas"}:
        raise AssertionError(f"4-card run on {stats.engine_tiles}")
    walls = [wall]
    with on_one_card():
        one, _, wall = run_reads(ds.genome, ds.reads, cfg, "1 card", card)
        walls.append(wall)
        walls.append(run_reads(ds.genome, ds.reads, cfg, "1 card", card)[2])
    walls.append(run_reads(ds.genome, ds.reads, cfg, "4 cards", card)[2])
    log(f"  walls in order 4, 1, 1, 4 cards: "
        f"{[round(w, 3) for w in walls]} s")
    same_alignments("4 cards vs 1 card", alns, one)
    return n


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the headline deployment on the 4-card "
                        "pairs mesh, compared with one card")
    args = p.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (platform {dev.platform!r})",
              file=sys.stderr)
        return 1
    card = card_info()
    log(f"phase 1 device: {dev.device_kind} x{len(jax.devices())} "
        f"({dev.platform}); card: {card}")
    t0 = time.perf_counter()
    if args.four_cards:
        log("phase 4-card headline")
        count = four_cards(card)
    else:
        log("phase 2 headline read mapping")
        ds, cfg = phase_headline(card)
        log("phase 3 short reads")
        phase_short(card)
        log("phase 4 retry path")
        phase_retry()
        log("phase 5 kernel parity at real widths")
        phase_widths()
        log("phase 6 kernel versus engine_xla")
        phase_timing(ds, cfg, card)
        count = len(jax.devices())
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s; card: "
        f"{card}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
