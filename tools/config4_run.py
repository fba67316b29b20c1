#!/usr/bin/env python3
"""BASELINE config 4 at scale: multi-chromosome reference resident on the device,
long reads streamed against it in chunks.

The reference's full-dataset runs stream ~1M PBSIM2 reads against a real
genome with the genome packed once into managed memory
(/root/reference/src/genasm_gpu.cu:692-743, README.md:155-160). This
driver reproduces that shape end-to-end on the device: a ~1 Gbase
multi-chromosome simulated genome is packed/uploaded ONCE (PreparedGenome),
then read chunks stream through align_reads with packed-CIGAR output.

Usage:
  python tools/config4_run.py [--genome_bases N] [--chroms N] [--reads N]
      [--chunk N] [--read_len N] [--tile N] [--out profile/config4_scale.csv]

Prints one JSON summary line and appends a CSV row with throughput and
peak host RSS.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import sys

# runnable as `python tools/<name>.py` from anywhere: the package lives in
# the repo root, which is the script's parent directory (sys.path gets the
# script dir, not the CWD)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import resource
import sys
import time

# persistent compile cache (same as bench.py)
_cache = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                      ".jax_cache")
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", _cache)
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "0")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--genome_bases", type=int, default=1_000_000_000)
    p.add_argument("--chroms", type=int, default=24)
    p.add_argument("--reads", type=int, default=1_000_000)
    p.add_argument("--chunk", type=int, default=65_536)
    p.add_argument("--read_len", type=int, default=10_000)
    p.add_argument("--tile", type=int, default=32_768)
    p.add_argument("--accuracy", type=float, default=0.95)
    p.add_argument("--out", default="profile/config4_scale.csv")
    args = p.parse_args(argv)

    from scrooge_tpu.api import align_reads, prepare_genome
    from scrooge_tpu.config import AlignConfig
    from scrooge_tpu.utils.simulate import (random_multichrom_genome,
                                            simulate_reads)

    t0 = time.perf_counter()
    genome = random_multichrom_genome(args.genome_bases, args.chroms,
                                      seed=101)
    print(f"# genome: {args.genome_bases} bases, {args.chroms} chromosomes "
          f"({time.perf_counter() - t0:.1f}s to simulate)", file=sys.stderr)

    cfg = AlignConfig(W=64, K=64, O=33, batch_tile=args.tile)
    pg = prepare_genome(genome)

    # warmup: compile + first genome upload, outside the timed stream
    warm = simulate_reads(genome, min(args.tile, args.chunk), args.read_len,
                          args.accuracy, seed=7)
    t0 = time.perf_counter()
    align_reads(pg, warm, cfg)
    print(f"# warmup (compile + genome upload): "
          f"{time.perf_counter() - t0:.1f}s", file=sys.stderr)

    pairs = 0
    core_ns = 0
    align_s = 0.0
    sim_s = 0.0
    retried = 0
    total_runs = 0
    ed_sum = 0
    chunk_no = 0
    while pairs < args.reads:
        n = min(args.chunk, args.reads - pairs)
        ts = time.perf_counter()
        reads = simulate_reads(genome, n, args.read_len, args.accuracy,
                               seed=1000 + chunk_no)
        sim_s += time.perf_counter() - ts
        ta = time.perf_counter()
        packed, stats = align_reads(pg, reads, cfg, return_stats=True,
                                    return_packed=True)
        align_s += time.perf_counter() - ta
        pairs += len(packed)
        core_ns += stats.core_ns
        retried += stats.retried_pairs
        total_runs += int(packed.run_offsets[-1])
        ed_sum += int(packed.edit_distances.sum())
        chunk_no += 1
        print(f"# chunk {chunk_no}: {pairs}/{args.reads} pairs, "
              f"stream so far {pairs / align_s:,.0f} aligns/s",
              file=sys.stderr)

    rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    row = {
        "genome_bases": args.genome_bases, "chromosomes": args.chroms,
        "pairs": pairs, "read_len": args.read_len, "batch_tile": args.tile,
        "accuracy": args.accuracy,
        "kernel_aligns_per_second": round(pairs * 1e9 / max(core_ns, 1), 1),
        "stream_aligns_per_second": round(pairs / align_s, 1),
        "simulate_s": round(sim_s, 1), "align_s": round(align_s, 1),
        "retried_pairs": retried, "total_cigar_runs": total_runs,
        "edit_distance_sum": ed_sum, "peak_rss_gb": round(rss_gb, 2),
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    new = not os.path.exists(args.out)
    with open(args.out, "a", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(row.keys()))
        if new:
            w.writeheader()
        w.writerow(row)
    print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
