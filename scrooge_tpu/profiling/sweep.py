"""Parameter-sweep driver (scripts/profile.py analogue).

The reference RECOMPILES its C++/CUDA binaries per configuration point
(-DCLI_W=.. etc, profile.py:28-33) and regex-scrapes stdout. Here the knobs
are runtime parameters of a single Python process: changing a knob re-jits
(XLA retrace) instead of re-running make, and throughput comes from
AlignStats directly. CSV schemas follow the reference's where the axis
exists here (profile.py:82,610):

  throughput sweeps -> ["W", "O", "early termination", "batch",
                        "aligns/second", ...engine, spread, "device"]
  accuracy sweeps   -> ["W", "O", "pair_idx", "score"(, "cigar", "read",
                        "reference")]

The "batch" column carries the batch tile (pairs) — the analogue of the
reference's CPU thread count / GPU thread-block count axis. The
reference's SENE/DENT memory-layout toggles are NOT throughput axes here:
the device engines always store truncated entries (strictly less memory
with no downside, config.py docstring), so device CSVs don't carry
those columns — the layout axis lives in the Python oracle
(pyref.genasm_dc) and the ASIC model (profiling/model.py) only.

Usage:
  python -m scrooge_tpu.profiling.sweep device <dataset>   # throughput, GPU
  python -m scrooge_tpu.profiling.sweep tbcap <dataset>    # tb_cap, GPU
  python -m scrooge_tpu.profiling.sweep xla <dataset>      # XLA engine
  python -m scrooge_tpu.profiling.sweep accuracy <dataset> [--cigar]
  <dataset> is a subdirectory of --datasets_dir with reference.fasta,
  reads.fastq, candidates.[maf|paf] (profile.py:650 contract), or
  'simulated[:reads[:length]]' for the built-in PBSIM2-style generator.
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import os
import sys
from datetime import datetime
from itertools import product
from pathlib import Path
from typing import List, Optional

from .. import api
from ..cigar import affine_score
from ..config import AlignConfig


def csv_write(path, rows, header):
    os.makedirs(os.path.dirname(str(path)) or ".", exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(rows)


def _load(dataset: str, datasets_dir: Path, with_truth: bool = False):
    if dataset.startswith("simulated"):
        from ..utils.simulate import simulate_dataset

        parts = dataset.split(":")
        num = int(parts[1]) if len(parts) > 1 else 512
        rlen = int(parts[2]) if len(parts) > 2 else 10_000
        decoys = float(parts[3]) if len(parts) > 3 else 0.0
        # parts[4]: read accuracy — 0.95 matches the PBSIM2 default the
        # reference benchmarks at (DATASETS.md:45-60); ~0.85 models ONT
        accuracy = float(parts[4]) if len(parts) > 4 else 0.95
        ds = simulate_dataset(genome_len=1_000_000, num_reads=num,
                              read_len=rlen, accuracy=accuracy, seed=11,
                              with_truth=with_truth, decoys=decoys)
        return ((ds.genome, ds.reads, ds.truth) if with_truth
                else (ds.genome, ds.reads))
    from .. import io as sio

    genome, reads = sio.load_dataset(datasets_dir / dataset)
    if not with_truth:
        return genome, reads
    from ..tools.cigar_tools import maf_truth_rows

    maf = datasets_dir / dataset / "candidates.maf"
    if not maf.exists():
        raise FileNotFoundError(
            "groundtruth accuracy needs a gapped candidates.maf "
            f"(none in {datasets_dir / dataset})")
    return genome, reads, maf_truth_rows(str(maf))


def _run_throughput(genome, reads, cfg: AlignConfig, data: List,
                    batch_col: int) -> bool:
    from ..api import _resolve_backend

    try:
        engine = _resolve_backend(cfg)
        if engine == "pallas":
            # engine-only rate — what the reference's sweep metric
            # measures (the binary's kernel section, profile.py:55-63);
            # the api-level core_ns is pipeline accounting that also
            # spans compaction (kernel_time module docstring)
            from .kernel_time import engine_seconds, stage_mapped

            staged = stage_mapped(genome.content, reads, cfg)
            secs = sorted(engine_seconds(staged, "pallas"))
            rate, lo, hi = (staged.num_pairs / secs[len(secs) // 2],
                            staged.num_pairs / secs[-1],
                            staged.num_pairs / secs[0])
        else:
            # api core accounting. Warm up TWICE: the first run takes
            # the slow compaction path (and fills the predicted-cap
            # cache), the second compiles the predicted-cap fast-path
            # programs, which would otherwise land inside the timed run
            warm = reads[: min(len(reads), cfg.batch_tile)]
            api.align_reads(genome, warm, cfg)
            api.align_reads(genome, warm, cfg)
            _, stats = api.align_reads(genome, reads, cfg,
                                       return_stats=True)
            rate = lo = hi = stats.aligns_per_second
    except Exception as e:  # config failed: record nothing, keep sweeping
        print(f"config failed ({e})", file=sys.stderr)
        return False
    data.append([cfg.W, cfg.O, cfg.early_termination, batch_col,
                 round(rate, 1), engine, round(lo, 1), round(hi, 1),
                 _device_kind()])
    return True


def _device_kind() -> str:
    """The device the row was measured on, as JAX names it ("cpu" for the
    CPU backend, the card's model on a GPU)."""
    import jax

    return jax.devices()[0].device_kind


RUN_BUFFER_BUDGET = 5 << 30  # device-memory headroom for the run buffers


def _max_batch_for(cfg: AlignConfig, read_len: int,
                   budget: int = RUN_BUFFER_BUDGET) -> int:
    """Largest batch tile whose worst-case CIGAR-run buffers fit `budget`.

    The per-tile run store is (maxw, NE3, B) uint16 with NE3 = 2*tb_cap+2
    (engine_pallas.tb_rows) plus counts and ~2x that again in compaction
    temporaries; small-tb_limit configs (small W, or O close to W)
    multiply maxw, and an out-of-memory failure can poison the device
    client for subsequent configs, so the cap is applied up front, not
    discovered by retry."""
    maxw = -(-cfg.max_windows(read_len) // 32) * 32
    ne3 = 2 * cfg.tb_cap + 2
    per_lane = maxw * (ne3 * 2 * 3 + 4)  # entries + ~2x temps + counts
    b = int(budget // max(per_lane, 1))
    return max(1024, (b // 1024) * 1024)


def _run_throughput_ladder(genome, reads, cfg: AlignConfig, data: List,
                           batch: int):
    """Run at the largest memory-safe batch tile <= requested, halving on
    unexpected failure down to 1024. The recorded batch column keeps
    reduced-batch rows honest."""
    read_len = max((len(r.content) for r in reads), default=1)
    b = min(batch, _max_batch_for(cfg, read_len))
    if b < batch:
        print(f"W={cfg.W} O={cfg.O}: run buffers cap batch at {b}",
              file=sys.stderr)
    floor = min(1024, batch)  # sub-1024 tiles (tests) run once, no ladder
    b = max(b if batch >= 1024 else batch, floor)
    while b >= floor:
        cfg_b = dataclasses.replace(cfg, batch_tile=b)
        # time exactly ONE full tile: pad lanes in a trailing tile are
        # real device time (up to 2x understatement), and multi-tile runs
        # overlap tile n's readback with tile n+1's upload. The reference
        # sweep likewise times fully-occupied single runs.
        full = reads[: min(len(reads), b)]
        if _run_throughput(genome, full, cfg_b, data, b):
            return
        b //= 2
        print(f"retrying W={cfg.W} O={cfg.O} at batch {b}",
              file=sys.stderr)
    # last resort: the XLA engine at a small batch — a config that
    # exhausts (or faults) the kernel still gets an honest row, marked by
    # its engine column
    if cfg.backend == "auto":
        bx = min(2048, max(floor, 1024))
        cfg_x = dataclasses.replace(cfg, backend="xla", batch_tile=bx)
        print(f"W={cfg.W} O={cfg.O}: kernel exhausted; XLA fallback row "
              f"at batch {bx}", file=sys.stderr)
        _run_throughput(genome, reads[: min(len(reads), bx)], cfg_x,
                        data, bx)


THROUGHPUT_HEADER = ["W", "O", "early termination", "batch",
                     "aligns/second", "engine",
                     # spread over kernel_time.engine_seconds' 3 timed
                     # calls (median is the aligns/second column);
                     # api-accounted rows carry the single measurement in
                     # all three columns
                     "aligns/second min", "aligns/second max", "device"]


def sweep_wo(genome, reads, backend: str, out: Path, max_experiments: int,
             repetitions: int, batch: int, max_W: int = 256):
    """W sweep with O = min(W//2+1, W-1) (profile.py:65-82). ET is the
    one layout/optimization toggle that is a real device performance axis
    (SENE/DENT aren't: see module docstring)."""
    gran = max(16, max_W // max(1, max_experiments))
    Ws = [w for w in range(gran, max_W + 1, gran)]
    data: List = []
    configs = [(w, et) for w, et in product(Ws, [False, True])]
    for idx, (W, et) in enumerate(configs):
        print(f"[{datetime.now()}] sweep_wo {idx}/{len(configs)}",
              file=sys.stderr)
        O = min(W // 2 + 1, W - 1)
        cfg = AlignConfig(W=W, K=W, O=O, early_termination=et,
                          backend=backend, batch_tile=batch)
        for _ in range(repetitions):
            _run_throughput_ladder(genome, reads, cfg, data, batch)
        csv_write(out, data, THROUGHPUT_HEADER)  # durable per config


def sweep_o(genome, reads, backend: str, out: Path, max_experiments: int,
            repetitions: int, batch: int, W: int = 64):
    gran = max(4, W // max(1, max_experiments))
    Os = [o for o in range(gran - 1, W, gran) if 0 <= o < W]
    data: List = []
    for idx, (O, et) in enumerate(product(Os, [False, True])):
        print(f"[{datetime.now()}] sweep_o {idx}", file=sys.stderr)
        cfg = AlignConfig(W=W, K=W, O=O, early_termination=et,
                          backend=backend, batch_tile=batch)
        for _ in range(repetitions):
            _run_throughput_ladder(genome, reads, cfg, data, batch)
        csv_write(out, data, THROUGHPUT_HEADER)


def sweep_batch(genome, reads, backend: str, out: Path, max_experiments: int,
                repetitions: int, W: int = 64):
    """Batch-tile sweep — the analogue of the reference's thread sweep
    (profile.py:104-122) / GPU thread-block sweep (profile.py:177-248).
    Datasets smaller than a tile would measure padding, so oversized
    tiles are dropped."""
    tiles = [1024, 2048, 4096, 8192, 16384, 24576,
             32768][: max(1, max_experiments)]
    tiles = [t for t in tiles if t <= max(1024, len(reads))]
    data: List = []
    O = W // 2 + 1
    for idx, tile in enumerate(tiles):
        print(f"[{datetime.now()}] sweep_batch {idx}/{len(tiles)}",
              file=sys.stderr)
        cfg = AlignConfig(W=W, K=W, O=O, backend=backend, batch_tile=tile)
        for _ in range(repetitions):
            # one full tile per row (see _run_throughput_ladder)
            _run_throughput(genome, reads[:tile], cfg, data, tile)
        csv_write(out, data, THROUGHPUT_HEADER)


def sweep_tbcap(genome, reads, out: Path, batch: int, W: int = 64,
                caps=(8, 16, 24, 32, 48, 64)):
    """tb_cap sweep: the kernel's per-window d-search cap vs the
    retry cliff (config.tb_cap docstring). On high-error inputs windows
    whose edit distance exceeds tb_cap fail their lane to the batched
    full-K XLA retry; this records how often that happens and what it
    costs at each cap. CSV: tb_cap, batch, pairs, retried_pairs,
    fail_tb_pairs, aligns/second, end_to_end_aligns/second, device."""
    import time as _time

    data: List = []
    for cap in caps:
        if cap > W:
            continue
        cfg = AlignConfig(W=W, K=W, O=W // 2 + 1, batch_tile=batch,
                          tb_cap_override=cap)
        print(f"[{datetime.now()}] tbcap {cap}", file=sys.stderr)
        try:
            api.align_reads(genome, reads[: min(len(reads), batch)], cfg)
            t0 = _time.perf_counter()
            _, stats = api.align_reads(genome, reads, cfg,
                                       return_stats=True)
            wall = _time.perf_counter() - t0
        except Exception as e:
            print(f"tb_cap={cap} failed ({e})", file=sys.stderr)
            continue
        data.append([cap, batch, stats.num_pairs, stats.retried_pairs,
                     stats.fail_tb_pairs, stats.aligns_per_second,
                     stats.num_pairs / wall, _device_kind()])
        csv_write(out, data, ["tb_cap", "batch", "pairs", "retried_pairs",
                              "fail_tb_pairs", "aligns/second",
                              "end_to_end_aligns/second", "device"])


def accuracy_sweep(genome, reads, out: Path, max_experiments: int,
                   cigar: bool, backend: str, batch: int,
                   max_W: int = 256):
    """Per-pair affine scores across W (profile.py:588-610): dumps
    pair_idx/score(/cigar) rows, plus the exact-aligner rows as the
    'edlib' accuracy gold standard (algorithm column in all_accuracy,
    cpu_baseline.cpp:784-875)."""
    scoring = dict(match=2, mismatch=4, gap_open=4, gap_extend=2)
    header = ["W", "O", "pair_idx", "score"] + (
        ["cigar", "read", "reference"] if cigar else [])
    gran = max(16, max_W // max(1, max_experiments))
    Ws = list(range(gran, max_W + 1, gran))
    data: List = []
    for idx, W in enumerate(Ws):
        print(f"[{datetime.now()}] accuracy_sweep {idx}/{len(Ws)}",
              file=sys.stderr)
        O = min(W // 2 + 1, W - 1)
        cfg = AlignConfig(W=W, K=W, O=O, backend=backend, batch_tile=batch)
        try:
            alns = api.align_reads(genome, reads, cfg)
        except Exception as e:
            print(f"config failed ({e})", file=sys.stderr)
            continue
        pair_idx = 0
        for read in reads:
            for loc in read.locations:
                a = alns[pair_idx]
                score = affine_score(a.cigar, **scoring)
                row = [W, O, pair_idx, score]
                if cigar:
                    row += [a.cigar, read.content,
                            genome.content[loc.start_in_reference:
                                           loc.start_in_reference
                                           + len(read.content) * 2]]
                data.append(row)
                pair_idx += 1
        csv_write(out, data, header)  # durable per config
    csv_write(out, data, header)


def sweep_baselines(genome, reads, out: Path, batch: int,
                    baseline_pairs: int = 32, algorithms=None):
    """Throughput of every first-party algorithm on one dataset — the
    reference's cpu_baselines sweep (profile.py:250-313, CSV consumed by
    the baseline-comparison figure). The scalar-DP baselines run on a
    subset of ``baseline_pairs`` reads (they are O(n*m) per pair; the
    reference's vendored C baselines have the same role but native
    speed), the device engines on the full read set; aligns/second is
    per-pair normalized either way."""
    from ..cli.baseline_cli import _align_with

    algorithms = algorithms or ["genasm_device", "genasm_xla", "exact",
                                "affine", "banded", "wfa", "wfa_lm",
                                "gact", "sw", "edlib"]
    few = list(reads)[: baseline_pairs]
    data: List = []
    for alg in algorithms:
        subset = few if alg in ("exact", "affine", "banded", "wfa",
                                "wfa_lm", "gact", "sw", "edlib",
                                "genasm_pyref") else reads
        # the XLA engine is the slow fallback: its row runs at a capped
        # batch (recorded honestly in the threads column)
        b_alg = min(batch, 8192) if alg == "genasm_xla" else batch
        sub_alg = subset[:b_alg] if alg == "genasm_xla" else subset
        print(f"[{datetime.now()}] baselines {alg} ({len(sub_alg)} reads)",
              file=sys.stderr)
        try:
            if alg == "genasm_device":
                # the engine-only metric (kernel_time), the SAME protocol
                # as every device throughput row in the sweeps; needs a GPU
                from .kernel_time import kernel_rate, stage_mapped

                cfgD = AlignConfig(backend="auto", batch_tile=b_alg)
                staged = stage_mapped(genome.content, sub_alg, cfgD)
                data.append([alg, b_alg, staged.num_pairs,
                             kernel_rate(staged)])
                csv_write(out, data, ["algorithm", "threads", "pairs",
                                      "aligns/second"])
                continue
            if alg.startswith("genasm_") and alg != "genasm_pyref":
                # warmup: jit compile outside the timed run (the scalar
                # DP baselines have nothing to warm — skip the double run)
                _align_with(alg, genome,
                            sub_alg[: min(len(sub_alg), b_alg)], b_alg)
            _, aps = _align_with(alg, genome, sub_alg, b_alg)
        except Exception as e:
            print(f"{alg} failed ({e})", file=sys.stderr)
            continue
        data.append([alg, b_alg, len(sub_alg), aps])
        csv_write(out, data, ["algorithm", "threads", "pairs",
                              "aligns/second"])
    csv_write(out, data, ["algorithm", "threads", "pairs", "aligns/second"])


def groundtruth_accuracy(genome, reads, truth, out: Path,
                         max_experiments: int, backend: str, batch: int,
                         max_W: int = 128, Os=None):
    """Fraction of ground-truth matched bases each CIGAR aligns
    identically, swept over W (and optionally O) — the
    accuracy-vs-groundtruth evaluation of profile.py:446-645 /
    plot.py:2724-2952, with the PBSIM2 MAF rows supplied by the built-in
    simulator (utils.simulate with_truth) or a gapped candidates.maf.

    CSV rows: W, O, pair_idx, score, correct_fraction."""
    from ..tools.cigar_tools import correctly_aligned_fraction

    scoring = dict(match=2, mismatch=4, gap_open=4, gap_extend=2)
    gran = max(16, max_W // max(1, max_experiments))
    Ws = list(range(gran, max_W + 1, gran))
    data: List = []
    for idx, W in enumerate(Ws):
        os_list = Os or [min(W // 2 + 1, W - 1)]
        for O in os_list:
            if not 0 <= O < W:
                continue
            print(f"[{datetime.now()}] groundtruth {idx}/{len(Ws)} "
                  f"W={W} O={O}", file=sys.stderr)
            cfg = AlignConfig(W=W, K=W, O=O, backend=backend,
                              batch_tile=batch)
            try:
                alns = api.align_reads(genome, reads, cfg)
            except Exception as e:
                print(f"config failed ({e})", file=sys.stderr)
                continue
            pair_idx = 0
            for ri, read in enumerate(reads):
                ref_row, read_row = truth[ri]
                for _ in read.locations:
                    a = alns[pair_idx]
                    frac = correctly_aligned_fraction(a.cigar, ref_row,
                                                      read_row)
                    data.append([W, O, pair_idx,
                                 affine_score(a.cigar, **scoring),
                                 round(frac, 6)])
                    pair_idx += 1
            csv_write(out, data, ["W", "O", "pair_idx", "score",
                                  "correct_fraction"])  # durable
    csv_write(out, data, ["W", "O", "pair_idx", "score",
                          "correct_fraction"])


def groundtruth_baselines(genome, reads, truth, out: Path,
                          algorithms=None):
    """Fraction of ground-truth matched bases each *baseline* aligns
    identically — the baseline rows of the reference's ground-truth
    accuracy comparison (plot.py:2724-2952 plots genasm against its
    vendored baselines on the same axis).

    CSV rows: algorithm, pair_idx, score, correct_fraction."""
    from ..cli.baseline_cli import _align_with
    from ..tools.cigar_tools import correctly_aligned_fraction

    scoring = dict(match=2, mismatch=4, gap_open=4, gap_extend=2)
    algorithms = list(algorithms
                      or ["exact", "affine", "banded", "wfa", "gact", "edlib"])
    data: List = []
    for alg in algorithms:
        print(f"[{datetime.now()}] groundtruth_baselines {alg}",
              file=sys.stderr)
        try:
            alns, _ = _align_with(alg, genome, reads, 2048)
        except Exception as e:
            print(f"{alg} failed ({e})", file=sys.stderr)
            continue
        pair_idx = 0
        for ri, read in enumerate(reads):
            ref_row, read_row = truth[ri]
            for _loc in read.locations:
                a = alns[pair_idx]
                frac = correctly_aligned_fraction(a.cigar, ref_row,
                                                  read_row)
                data.append([alg, pair_idx,
                             affine_score(a.cigar, **scoring),
                             round(frac, 6)])
                pair_idx += 1
    csv_write(out, data,
              ["algorithm", "pair_idx", "score", "correct_fraction"])


def baselines_accuracy(genome, reads, out: Path, cigar: bool,
                       algorithms=None):
    """Per-pair affine scores for every first-party baseline — the
    reference's accuracy_baselines driver (cpu_baseline.cpp:784-875),
    which dumps pair_idx/score(/cigar) rows per algorithm for the
    score-distribution comparison figures."""
    from ..cli.baseline_cli import _align_with

    scoring = dict(match=2, mismatch=4, gap_open=4, gap_extend=2)
    algorithms = list(algorithms
                      or ["exact", "affine", "banded", "wfa", "gact", "edlib"])
    data: List = []
    for alg in algorithms:
        print(f"[{datetime.now()}] baselines_accuracy {alg}",
              file=sys.stderr)
        try:
            alns, _ = _align_with(alg, genome, reads, 2048)
        except Exception as e:
            print(f"{alg} failed ({e})", file=sys.stderr)
            continue
        pair_idx = 0
        for read in reads:
            for _loc in read.locations:
                a = alns[pair_idx]
                score = affine_score(a.cigar, **scoring)
                row = [alg, pair_idx, score] + ([a.cigar] if cigar else [])
                data.append(row)
                pair_idx += 1
    header = ["algorithm", "pair_idx", "score"] + (["cigar"] if cigar else [])
    csv_write(out, data, header)




def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        description="Sweep device/XLA throughput or accuracy over configs")
    p.add_argument("target",
                   choices=["device", "xla", "accuracy", "groundtruth",
                            "baselines", "tbcap"])
    p.add_argument("dataset", type=str,
                   help="datasets_dir subdirectory or "
                        "'simulated[:N[:len[:decoys]]]' (decoys>0 = the "
                        "chained candidate model: extra wrong candidates "
                        "per read)")
    p.add_argument("--datasets_dir", type=Path, default=Path("datasets"))
    p.add_argument("--profile_dir", type=Path, default=Path("profile"))
    p.add_argument("--max_experiments", type=int, default=8)
    p.add_argument("--repetitions", type=int, default=1)
    p.add_argument("--override_W", type=int, default=None)
    p.add_argument("--max_W", type=int, default=256)
    p.add_argument("--batch_tile", type=int, default=2048)
    p.add_argument("--baseline_pairs", type=int, default=32)
    p.add_argument("--cigar", action="store_true")
    p.add_argument("--families", type=str, default=None,
                   help="comma subset of device/xla sweep families to run "
                        "(WO,O,batch); default all — use to rerun a family "
                        "in a fresh process after a device fault")
    p.add_argument("--Os", type=str, default=None,
                   help="comma list of overlaps for the groundtruth "
                        "target (the O axis of the reference's W/O "
                        "accuracy trade-off, profile.py:588-645); "
                        "combine with --override_W --max_W W "
                        "--max_experiments 1 for a pure O sweep")
    args = p.parse_args(argv)

    if args.target in ("device", "tbcap"):
        # the kernel's own sweeps: without a GPU, auto would time
        # engine_xla on the CPU and write it under the device sweep's name
        from .kernel_time import require_gpu

        require_gpu()
    if args.target == "groundtruth":
        genome, reads, truth = _load(args.dataset, args.datasets_dir,
                                     with_truth=True)
    else:
        genome, reads = _load(args.dataset, args.datasets_dir)
    name = args.dataset.replace(":", "_")
    out = args.profile_dir
    backend = "auto" if args.target == "device" else "xla"
    W = args.override_W or 64

    if args.target == "groundtruth":
        os_list = ([int(x) for x in args.Os.split(",") if x]
                   if args.Os else None)
        suffix = "_O" if os_list else ""
        groundtruth_accuracy(genome, reads, truth,
                             out / f"{name}_groundtruth_accuracy"
                                   f"{suffix}.csv",
                             args.max_experiments, "auto", args.batch_tile,
                             args.max_W, Os=os_list)
        # the baselines have no W/O dependence: skip them on --Os
        # O-sweeps (the W-sweep run already recorded them) and when
        # --baseline_pairs=0
        few = list(reads)[: args.baseline_pairs]
        if few and not os_list:
            groundtruth_baselines(genome, few, truth[: len(few)],
                                  out / f"{name}_groundtruth_baselines.csv")
    elif args.target == "baselines":
        sweep_baselines(genome, reads, out / f"{name}_baselines.csv",
                        args.batch_tile, args.baseline_pairs)
    elif args.target == "tbcap":
        sweep_tbcap(genome, reads, out / f"{name}_tbcap.csv",
                    args.batch_tile, W)
    elif args.target in ("device", "xla"):
        # one crashing family (a poisoned device client after an OOM)
        # must not take down the remaining families' durable CSVs;
        # --families reruns a subset in a fresh process
        tag = args.target
        families = {
            "WO": lambda: sweep_wo(genome, reads, backend,
                                   out / f"{name}_{tag}_sweep_WO.csv",
                                   args.max_experiments, args.repetitions,
                                   args.batch_tile, args.max_W),
            "O": lambda: sweep_o(genome, reads, backend,
                                 out / f"{name}_{tag}_sweep_O.csv",
                                 args.max_experiments, args.repetitions,
                                 args.batch_tile, W),
            "batch": lambda: sweep_batch(genome, reads, backend,
                                         out / f"{name}_{tag}_sweep_batch.csv",
                                         args.max_experiments,
                                         args.repetitions, W),
        }
        wanted = (args.families.split(",") if args.families
                  else list(families))
        for fname in wanted:
            try:
                families[fname]()
            except Exception as e:
                print(f"sweep family {fname} failed ({e})", file=sys.stderr)
    else:
        cig = "_cigar" if args.cigar else ""
        accuracy_sweep(genome, reads,
                       out / f"{name}_accuracy_sweep_wo{cig}.csv",
                       args.max_experiments, args.cigar, "auto",
                       args.batch_tile, args.max_W)
        baselines_accuracy(genome, reads,
                           out / f"{name}_baselines_accuracy{cig}.csv",
                           args.cigar)
    return 0


if __name__ == "__main__":
    sys.exit(main())
