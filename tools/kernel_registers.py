#!/usr/bin/env python3
"""Registers, spills and engine time of the window kernel by W and fill band.

The kernel's shape (engine_pallas.FILL_BAND, MAX_KERNEL_W) rests on what
this measures: for each (W, band) it compiles
the kernel with XLA's dump on, runs the dumped PTX through the CUDA
toolkit's `ptxas -v` for the kernel's registers and spill bytes per
thread, and times the kernel alone on simulated 10 kbp read-mapping pairs
(steady state, median of 3, block_until_ready). Configs the shape chooser
would not give the kernel are forced through it. With --xla W, engine_xla
is timed on the same pairs at that W.

    python tools/kernel_registers.py [--pairs 2048] [--xla 512]
        [--configs 64:4,64:2,224:4,224:2,256:4,256:2,512:2]

Needs a GPU and ptxas (PTXAS, or /usr/local/cuda/bin/ptxas). Prints one
line per config; the full ptxas report goes to --out.
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PTXAS = os.environ.get("PTXAS", "/usr/local/cuda/bin/ptxas")


def ptxas_report(files):
    """`ptxas -v` lines for the kernel's entry in the given PTX files:
    (registers, spill-store bytes, spill-load bytes, raw report)."""
    def has_kernel(path):
        with open(path, errors="ignore") as f:
            return "genasm" in f.read()

    for path in [f for f in files if has_kernel(f)] or files[:1]:
        proc = subprocess.run(
            [PTXAS, "-arch=sm_90a", "-v", "-o", os.devnull, path],
            capture_output=True, text=True, timeout=600)
        text = proc.stdout + proc.stderr
        block = text[text.find("genasm"):] if "genasm" in text else text
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", block)
        return (int(regs.group(1)) if regs else None,
                int(spill.group(1)) if spill else None,
                int(spill.group(2)) if spill else None, text)
    return None, None, None, "no PTX with the kernel among " + ", ".join(
        os.path.basename(p) for p in files)


def median_seconds(fn, reps=3):
    import jax

    jax.block_until_ready(fn())  # compile + warm
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2], times


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--pairs", type=int, default=2048)
    p.add_argument("--configs", default="64:4,64:2,224:4,224:2,256:4,"
                                        "256:2,512:2")
    p.add_argument("--xla", type=int, default=512,
                   help="W at which engine_xla is timed too (0: none)")
    p.add_argument("--out", default="chiprun_out/kernel_registers.txt")
    args = p.parse_args(argv)

    # XLA reads its flags when jax loads; every config must compile in
    # this process (no compile cache), or there is no PTX to read
    dump = tempfile.mkdtemp(prefix="kernel_registers_")
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + f" --xla_dump_to={dump}")
    os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)
    import jax

    jax.config.update("jax_enable_compilation_cache", False)
    from scrooge_tpu import AlignConfig
    from scrooge_tpu.ops import engine_pallas
    from scrooge_tpu.profiling import kernel_time as kt
    from scrooge_tpu.utils.simulate import simulate_dataset

    kt.require_gpu()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card: {card}; {args.pairs} pairs of 10 kbp at 95% accuracy",
          flush=True)
    ds = simulate_dataset(genome_len=1_000_000, num_reads=args.pairs,
                          read_len=10_000, accuracy=0.95, seed=7)
    chooser = engine_pallas.choose_kernel_shape
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as out:
        out.write(f"card: {card}\n")
        for item in args.configs.split(","):
            W, band = map(int, item.split(":"))
            cfg = AlignConfig(W=W, K=W, O=W // 2 + 1, batch_tile=args.pairs)
            st = kt.stage_mapped(ds.genome.content, ds.reads, cfg)
            engine_pallas.choose_kernel_shape = (
                lambda c, band=band: (engine_pallas.PAIRS_PER_BLOCK, band))
            jax.clear_caches()
            before = set(glob.glob(os.path.join(dump, "*")))
            t0 = time.perf_counter()
            res = jax.block_until_ready(kt.run_engine(st, "pallas"))
            compile_s = time.perf_counter() - t0
            new = sorted(set(glob.glob(os.path.join(dump, "*"))) - before)
            regs, sst, sld, report = ptxas_report(
                [f for f in new if f.endswith(".ptx")] or new[:40])
            med, times = median_seconds(lambda: kt.run_engine(st, "pallas"))
            engine_pallas.choose_kernel_shape = chooser
            failed = int((np.asarray(res.failed) != 0).sum())
            line = (f"W={W} O={cfg.O} band={band}: chooser "
                    f"{chooser(cfg)}; ptxas: "
                    f"{regs} registers, spill stores {sst} B, spill loads "
                    f"{sld} B; first call {compile_s:.1f} s; kernel "
                    f"{med * 1e3:.3f} ms median of "
                    f"{[round(t * 1e3, 3) for t in times]} ms = "
                    f"{st.num_pairs / med:.1f} aligns/s; "
                    f"{failed} lanes over tb_cap")
            print(line, flush=True)
            out.write(line + "\n" + report + "\n")
            out.flush()
            if W == args.xla:
                med_x, times_x = median_seconds(
                    lambda: kt.run_engine(st, "xla"))
                line = (f"W={W} O={cfg.O} engine_xla: {med_x:.3f} s median "
                        f"of {[round(t, 3) for t in times_x]} s = "
                        f"{st.num_pairs / med_x:.1f} aligns/s; kernel / "
                        f"engine_xla {med_x / med:.1f}x")
                print(line, flush=True)
                out.write(line + "\n")
    print(f"card: {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
