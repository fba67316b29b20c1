"""Headline benchmark: long-read alignment throughput (aligns/second).

Workload mirrors the reference's headline GPU benchmark (README.md:103-108):
PBSIM2-style long reads (10 kbp, 95% accuracy) aligned against a reference
genome at the representative config W=64, O=33, K=64 (plot.py:1277-1291).
Baseline: 25,004 aligns/second — the reference CUDA kernel's example
throughput on an RTX 3060 (kernel-only, as the headline here: the engine
alone, matching the reference's core_algorithm_ns split).

Needs a GPU: the engine-only pass raises without one, so no CPU number is
ever reported under a device metric. Prints ONE JSON line whose "device"
names the card every figure in it was measured on.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

# persistent XLA compilation cache: JAX_COMPILATION_CACHE_DIR when set,
# otherwise a fixed directory in the checkout (must be set before jax import)
_cache = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".jax_cache")
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", _cache)
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "0")

BASELINE_ALIGNS_PER_S = 25_004.0


def main():
    num_reads = int(os.environ.get("BENCH_READS", "32768"))
    read_len = int(os.environ.get("BENCH_READ_LEN", "10000"))
    genome_len = int(os.environ.get("BENCH_GENOME", "1000000"))
    # 0.95 = the PBSIM2 default the reference benchmarks at; ~0.85 models
    # ONT-class error rates (the tb_cap retry-cliff stress level)
    accuracy = float(os.environ.get("BENCH_ACCURACY", "0.95"))

    from scrooge_tpu.api import align_reads
    from scrooge_tpu.config import AlignConfig
    from scrooge_tpu.profiling.kernel_time import (engine_seconds,
                                                   require_gpu, stage_mapped)
    from scrooge_tpu.utils.simulate import simulate_dataset

    dev = require_gpu()
    import jax

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices()), "card": card}

    # BENCH_W/BENCH_O select the window config: default is the reference's
    # representative long-read point (W=64 O=33, plot.py:1277-1291); the
    # short-read point is W=32 O=17 (plot.py:1304-1331).
    W = int(os.environ.get("BENCH_W", "64"))
    cfg = AlignConfig(W=W, K=W,
                      O=int(os.environ.get("BENCH_O", str(W // 2 + 1))),
                      batch_tile=int(os.environ.get("BENCH_TILE", "16384")))
    ds = simulate_dataset(genome_len=genome_len, num_reads=num_reads,
                          read_len=read_len, accuracy=accuracy, seed=7)

    # warmup: compile over the FULL dataset (multi-tile runs hit
    # data-dependent compaction-cap buckets per tile), excluded from timing
    align_reads(ds.genome, ds.reads, cfg)
    walls = {}
    stats = None
    for packed in (False, True, False, True):
        t0 = time.perf_counter()
        out, st = align_reads(ds.genome, ds.reads, cfg, return_stats=True,
                              return_packed=packed)
        w = time.perf_counter() - t0
        key = "packed" if packed else "strings"
        if w < walls.get(key, float("inf")):
            walls[key] = w
            if not packed:
                stats = st
        del out

    # engine-only pass: the kernel called directly on staged pairs, as the
    # reference times genasm_kernel<<<>>> alone (genasm_gpu.cu:939-951)
    staged = stage_mapped(ds.genome.content, ds.reads, cfg)
    secs = sorted(engine_seconds(staged, "pallas", reps=3))
    kernel = staged.num_pairs / secs[len(secs) // 2]
    print(f"# {stats.breakdown()}", file=sys.stderr)
    long_read = read_len >= 1000
    out = {
        "metric": ("long_read" if long_read else "short_read")
                  + "_aligns_per_second",
        "value": round(kernel, 1),
        "unit": "aligns/s",
        "device": device,
        "kernel_aligns_min": round(staged.num_pairs / secs[-1], 1),
        "kernel_aligns_max": round(staged.num_pairs / secs[0], 1),
        "api_core_aligns_per_second": round(stats.aligns_per_second, 1),
        "end_to_end_aligns_per_second":
            round(stats.num_pairs / walls["strings"], 1),
        "end_to_end_packed_aligns_per_second":
            round(stats.num_pairs / walls["packed"], 1),
        "engines": stats.engine_tiles,
        "retried_pairs": stats.retried_pairs,
    }
    if long_read:
        out["vs_baseline"] = round(kernel / BASELINE_ALIGNS_PER_S, 4)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
