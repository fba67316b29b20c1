"""Multi-device scaling-efficiency measurement.

Measures aligned pairs/second on a 1-D ``pairs`` mesh at 1..N devices and
reports weak-scaling efficiency (fixed per-device batch), on engine_xla:
these are CPU proxies for the sharding itself. The kernel's sharded
program contains ZERO collectives (test_parallel.py asserts this on the
compiled HLO), so on real multi-GPU hardware the only scaling losses are
host dispatch and result readback.

On the virtual CPU mesh used in tests/CI
(``--xla_force_host_platform_device_count=N``) all "devices" share one
host's cores, so the absolute efficiencies measured there are a LOWER
bound sanity check (they mostly measure the host's core count), not an
interconnect result; the CSV records them with the platform column so they
are not mistaken for device scaling.

Usage:
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    python -m scrooge_tpu.profiling.scaling --out profile/scaling.csv

Multi-HOST mode (--distributed N): launches N real jax.distributed
processes on this machine (CPU + gloo collectives, the
parallel/distributed.py path) and measures weak-scaling efficiency of the
full read-mapping pipeline at 1 and N processes — the launch-ready harness
for the >=80%-efficiency-at-2-hosts BASELINE.json target. On an actual
multi-host cluster, run the worker on every host instead:

  python -m scrooge_tpu.profiling.scaling --dist_worker \
      $PID $NPROCS $COORDINATOR_PORT --per_process 32768

(any jax.distributed-recognized cluster env also works with pid/nprocs
auto-detected by dist.initialize).
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import sys
import time

import numpy as np


def _batch(B: int, read_len: int):
    rng = np.random.default_rng(5)
    tl = read_len + 80
    text = rng.integers(0, 4, (B, tl), dtype=np.uint8)
    pattern = np.where(
        rng.random((B, read_len)) < 0.05,
        rng.integers(0, 4, (B, read_len), dtype=np.uint8),
        text[:, :read_len]).astype(np.uint8)
    return (text, np.full(B, tl, np.int32), pattern,
            np.full(B, read_len, np.int32))


def measure(per_device: int, read_len: int, reps: int):
    import jax

    from ..config import AlignConfig
    from ..parallel import mesh as M

    cfg = AlignConfig(W=64, K=64, O=33)
    platform = jax.default_backend()
    n_all = len(jax.devices())
    rows = []
    base_aps = None
    n = 1
    while n <= n_all:
        B = per_device * n
        args = _batch(B, read_len)
        maxw = cfg.max_windows(read_len)
        mesh = M.make_mesh(n)

        def run():
            return M.align_batch_on_mesh(cfg, maxw, mesh, *args)

        jax.block_until_ready(run())  # compile + warm
        t0 = time.perf_counter()
        for _ in range(reps):
            jax.block_until_ready(run())
        dt = (time.perf_counter() - t0) / reps
        aps = B / dt
        if base_aps is None:
            base_aps = aps
        eff = aps / (base_aps * n)
        rows.append({"platform": platform, "engine": "xla", "devices": n,
                     "batch": B, "read_len": read_len,
                     "aligns_per_second": round(aps, 1),
                     "weak_scaling_efficiency": round(eff, 4)})
        print(f"devices={n} batch={B} {aps:,.0f} aligns/s "
              f"eff={eff:.2%}", file=sys.stderr)
        n *= 2
    return rows


def measure_device_time(per_device: int, read_len: int, reps: int):
    """Per-device DEVICE-TIME constancy proxy on the virtual CPU mesh.

    On ``--xla_force_host_platform_device_count=N`` every virtual device
    executes on the host's cores, so process CPU time is (up to host
    overhead) the SUM of all virtual devices' device time. With the
    per-device batch fixed, a sharding that adds no collectives and
    duplicates no work must consume N times the 1-device CPU time at N
    devices — i.e. constant per-device device time. work_ratio reports
    cpu_N / (N * cpu_1): ~1.0 = no sharding-induced work; >1 would mean
    the sharded program does extra per-device work (recompute,
    collectives, layout churn). This is the quantitative companion to the
    zero-collectives HLO assertion (tests/test_parallel.py) for the
    BASELINE >=80%-at-2-hosts target: constant per-device device time +
    zero steady-state collectives is exactly what that target needs from
    the program side (the rest is host dispatch, measured separately by
    the --distributed harness)."""
    import jax

    from ..config import AlignConfig
    from ..parallel import mesh as M

    cfg = AlignConfig(W=64, K=64, O=33)
    platform = jax.default_backend()
    n_all = len(jax.devices())
    # This proxy is DEFINED on the virtual CPU mesh: a 1-device or
    # accelerator run can never show N-device constancy. Hard-fail
    # instead of recording noise.
    if platform != "cpu" or n_all < 8:
        raise RuntimeError(
            f"measure_device_time requires the virtual CPU mesh "
            f"(JAX_PLATFORMS=cpu, --xla_force_host_platform_device_count"
            f">=8); got platform={platform!r} devices={n_all}. Run via "
            f"--device_time so the forced-env re-exec applies.")
    rows = []
    base_cpu = None
    n = 1
    while n <= n_all:
        B = per_device * n
        args = _batch(B, read_len)
        maxw = cfg.max_windows(read_len)
        mesh = M.make_mesh(n)

        def run():
            return M.align_batch_on_mesh(cfg, maxw, mesh, *args)

        np.asarray(run().edit_distance)  # compile + warm
        c0 = time.process_time()
        t0 = time.perf_counter()
        for _ in range(reps):
            np.asarray(run().edit_distance)
        cpu = (time.process_time() - c0) / reps
        wall = (time.perf_counter() - t0) / reps
        if base_cpu is None:
            base_cpu = cpu
        ratio = cpu / (base_cpu * n)
        rows.append({"platform": platform, "engine": "xla", "devices": n,
                     "batch": B, "read_len": read_len,
                     "cpu_s": round(cpu, 4), "wall_s": round(wall, 4),
                     "per_device_cpu_s": round(cpu / n, 4),
                     "work_ratio": round(ratio, 4)})
        print(f"devices={n} batch={B} cpu={cpu:.3f}s "
              f"per-device={cpu / n:.3f}s work_ratio={ratio:.3f}",
              file=sys.stderr)
        n *= 2
    return rows


def _dist_worker(pid: int, nproc: int, port: str, per_process: int,
                 read_len: int) -> int:
    """One jax.distributed process of the multi-host harness: aligns its
    round-robin pair shard of a deterministic dataset through the FULL
    read-mapping pipeline (api.align_reads), barriers around the timed
    section, and (process 0) prints one JSON result line."""
    from ..parallel import distributed as dist

    dist.initialize(coordinator_address=f"127.0.0.1:{port}",
                    num_processes=nproc, process_id=pid)
    import jax
    from jax.experimental import multihost_utils as mhu

    from .. import api
    from ..config import AlignConfig
    from ..utils.simulate import simulate_dataset

    total_pairs = per_process * nproc
    ds = simulate_dataset(genome_len=200_000, num_reads=total_pairs,
                          read_len=read_len, accuracy=0.95, seed=23)
    cfg = AlignConfig(W=64, K=64, O=33,
                      batch_tile=max(128, min(per_process, 2048)))
    local_reads, _ = dist.shard_reads(ds.reads)
    # warmup compile outside the timed window
    api.align_reads(ds.genome, local_reads[: cfg.batch_tile], cfg)
    mhu.sync_global_devices("scaling_start")
    c0 = time.process_time()
    t0 = time.perf_counter()
    api.align_reads(ds.genome, local_reads, cfg)
    local_dt = time.perf_counter() - t0
    # per-process CPU seconds of the aligned work itself (excludes the
    # end barrier below): on a host where N processes timeshare the same
    # cores, WALL efficiency is bounded by 1/N and measures the core
    # oversubscription, not the software — CPU seconds per pair is the
    # term that transfers to a real N-host run (each host then has its
    # own cores), so the launcher normalizes efficiency by it
    local_cpu = time.process_time() - c0
    mhu.sync_global_devices("scaling_end")
    wall = time.perf_counter() - t0  # includes the straggler barrier
    gathered = mhu.process_allgather(np.array([local_dt, local_cpu]))
    if jax.process_index() == 0:
        g = np.asarray(gathered).reshape(nproc, 2)
        print(json.dumps({
            "platform": jax.default_backend(), "processes": nproc,
            "per_process": per_process, "total_pairs": total_pairs,
            "read_len": read_len,
            "aligns_per_second": round(total_pairs / wall, 1),
            "slowest_process_s": round(float(g[:, 0].max()), 4),
            "cpu_s": round(float(g[:, 1].sum()), 4),
            "cpu_s_max": round(float(g[:, 1].max()), 4),
        }))
    return 0


def run_distributed(nproc_max: int, per_process: int, read_len: int,
                    out: str) -> int:
    """Launch 1- and N-process jax.distributed runs of _dist_worker on
    this machine (CPU + gloo) and record weak-scaling efficiency — the
    2-hosts-in-one-command harness for the BASELINE.json >=80% target.
    On a real pod, skip this launcher and start --dist_worker per host."""
    import os
    import socket
    import subprocess

    rows = []
    base_aps = None
    for n in sorted({1, nproc_max}):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="")
        procs = [subprocess.Popen(
            [sys.executable, "-m", "scrooge_tpu.profiling.scaling",
             "--dist_worker", f"{p}:{n}:{port}",
             "--per_process", str(per_process),
             "--read_len", str(read_len)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
            text=True) for p in range(n)]
        outs = [pr.communicate()[0] for pr in procs]
        if any(pr.returncode for pr in procs):
            raise RuntimeError(f"distributed run at n={n} failed")
        row = json.loads(outs[0].strip().splitlines()[-1])
        aps = row["aligns_per_second"]
        if base_aps is None:
            base_aps = aps
            base_cpu_per_pair = row["cpu_s"] / row["total_pairs"]
        row["weak_scaling_efficiency"] = round(aps / (base_aps * n), 4)
        # CPU-normalized efficiency: CPU seconds PER PAIR at N processes
        # vs 1 process. Wall efficiency on this single host is capped at
        # 1/N by core timesharing; cpu/pair is what a real N-host run
        # keeps (gloo transport, barrier spin, and serialization all land
        # in it), so >=0.8 here is the honest proxy for the BASELINE
        # >=80%-at-2-hosts target.
        cpu_per_pair = row["cpu_s"] / row["total_pairs"]
        row["cpu_normalized_efficiency"] = round(
            base_cpu_per_pair / cpu_per_pair, 4)
        print(f"processes={n} {aps:,.0f} aligns/s "
              f"eff={row['weak_scaling_efficiency']:.2%} "
              f"cpu_eff={row['cpu_normalized_efficiency']:.2%}",
              file=sys.stderr)
        rows.append(row)
    with open(out, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[-1].keys()))
        w.writeheader()
        w.writerows(rows)
    print(f"wrote {out}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--per_device", type=int, default=1024)
    p.add_argument("--read_len", type=int, default=600)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--out", default="profile/scaling.csv")
    p.add_argument("--distributed", type=int, default=0, metavar="N",
                   help="launch a real N-process jax.distributed "
                        "weak-scaling run on this machine (vs 1 process)")
    p.add_argument("--device_time", action="store_true",
                   help="measure per-device device-time constancy on the "
                        "virtual mesh (work_ratio ~1.0 = sharding adds no "
                        "per-device work) instead of wall throughput")
    p.add_argument("--per_process", type=int, default=2048)
    p.add_argument("--dist_worker", default=None, metavar="PID:NPROC:PORT",
                   help="internal: run as one distributed process")
    args = p.parse_args(argv)
    if args.dist_worker:
        pid, nproc, port = args.dist_worker.split(":")
        return _dist_worker(int(pid), int(nproc), port, args.per_process,
                            args.read_len)
    if args.distributed:
        return run_distributed(args.distributed, args.per_process,
                               args.read_len, args.out)
    if args.device_time:
        if os.environ.get("_SCROOGE_DT_CHILD") != "1":
            # This proxy is DEFINED on the virtual CPU mesh (see
            # measure_device_time doc). jax is already imported by the
            # time main() runs (the package pulls it in), so JAX_PLATFORMS
            # from os.environ is baked: re-exec a child with the env
            # forced BEFORE any import.
            import subprocess

            env = dict(os.environ, JAX_PLATFORMS="cpu",
                       _SCROOGE_DT_CHILD="1")
            flags = env.get("XLA_FLAGS", "")
            if "xla_force_host_platform_device_count" not in flags:
                flags += " --xla_force_host_platform_device_count=8"
            if "xla_llvm_disable_expensive_passes" not in flags:
                flags += " --xla_llvm_disable_expensive_passes=true"
            env["XLA_FLAGS"] = flags.strip()
            argv_out = sys.argv[1:] if argv is None else list(argv)
            return subprocess.call(
                [sys.executable, "-m", "scrooge_tpu.profiling.scaling",
                 *argv_out], env=env)
        rows = measure_device_time(args.per_device, args.read_len,
                                   args.reps)
    else:
        rows = measure(args.per_device, args.read_len, args.reps)
    with open(args.out, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
