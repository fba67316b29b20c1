"""`cpu_baseline` binary analogue: benchmark + accuracy comparison drivers.

Mirrors /root/reference/src/cpu_baseline.cpp (flags: :914-926; perf driver
benchmark_baselines :727-782; accuracy driver accuracy_baselines :784-875)
with this framework's algorithm set:

  genasm_device  — the device engine (auto backend: the window kernel
                   on a GPU)
  genasm_xla     — the portable XLA engine
  genasm_pyref   — the scalar oracle
  exact          — exact semiglobal edit-distance DP (the edlib role)
  affine         — exact affine-gap Gotoh DP (the ksw2 role)
  banded         — adaptive band-doubling aligner (the WFA-adaptive role)
  wfa            — first-party exact wavefront aligner, global on a
                   read-length text window (the wfa_exact role,
                   cpu_baseline.cpp:487-549)
  wfa_lm         — low-memory penalty-only wavefront pass (the wfa_lm
                   role, cpu_baseline.cpp:387-438; perf-only, no CIGAR —
                   the reference has no wfa_lm accuracy adapter either)
  gact           — GACT-tiling aligner (the Darwin custom-GACT role)
  sw             — exact local Smith-Waterman-Gotoh (the CUDASW++ role,
                   profile.py:379-444; local segment CIGAR, scores are
                   local-alignment scores)

Output formats are API (scraped by sweep tooling, profile.py:293 regex):
  "<algorithm>: <N.NN> aligns/second"
  "pair_idx=<i> score=<s>[ cigar=<c> read=<r> reference=<ref>]"
"""

from __future__ import annotations

import sys
import time
from typing import List

from .. import api
from ..baselines import (affine_semiglobal, banded_semiglobal,
                         exact_semiglobal)
from ..cigar import affine_score
from ..config import AlignConfig
from ..datamodel import Alignment
from . import options as opt

HELP_TEXT = """\
python -m scrooge_tpu.cli.baseline_cli [options]
Options:
--reference=[path to reference FASTA] -- override default reference data for performance test
--reads=[path to reads FASTQ]         -- override default reads data for performance test
--seeds=[path to MAF or PAF]          -- override default seeds data for performance test
--threads=[TILE[,MORE_TILES]]         -- run benchmarks with the given list of batch tiles (lanes) default:2048
--algorithms=[ALGORITHM[,MORE ALGORITHMS]] -- run only the specified algorithms, supported are: genasm_device, genasm_xla, genasm_pyref, exact, affine, banded, wfa, wfa_lm, gact, sw
--scoring=[MAT],[SUB],[GAPO],[GAPE]   -- set affine gap model scoring function, all values should be positive default:2,4,4,2
--simulated=[N[,LEN]]                 -- use a built-in simulated dataset instead of files
--verbose                             -- print progress to stderr. Otherwise, only benchmark results are printed
--accuracy                            -- print alignment score for each pair (do not run performance experiments)
--cigar                               -- print cigar string for each pair (requires --accuracy)
--help                                -- displays this information
"""

ALLOWED = ["--reference", "--reads", "--seeds", "--threads", "--algorithms",
           "--scoring", "--simulated", "--verbose", "--accuracy", "--cigar",
           "--help"]
ALL_ALGS = ["genasm_device", "genasm_xla", "genasm_pyref", "exact",
            "affine", "banded", "wfa", "wfa_lm", "gact", "sw", "edlib"]


def _load(args):
    st, sim = opt.get_value(args, "--simulated")
    if st == opt.Opt.VALUE:
        from ..utils.simulate import simulate_dataset

        parts = (sim or "").split(",")
        num = int(parts[0]) if parts[0] else 256
        rlen = int(parts[1]) if len(parts) > 1 else 2000
        ds = simulate_dataset(genome_len=500_000, num_reads=num,
                              read_len=rlen, accuracy=0.95, seed=13)
        return ds.genome, ds.reads
    from .. import io as sio

    _, ref = opt.get_value(args, "--reference", "datasets/default/reference.fasta")
    _, rds = opt.get_value(args, "--reads", "datasets/default/reads.fastq")
    _, sds = opt.get_value(args, "--seeds", "datasets/default/candidates.maf")
    genome = sio.read_genome(ref)
    return genome, sio.read_fastq_and_seed_locations(genome, rds, sds)


def _align_with(alg: str, genome, reads, tile: int):
    if alg in ("exact", "affine", "banded", "wfa", "wfa_lm", "gact",
               "sw", "edlib"):
        out: List[Alignment] = []
        t0 = time.perf_counter_ns()
        for read in reads:
            for loc in read.locations:
                start = loc.start_in_reference
                # gact's per-tile DP and wfa's global alignment both pay
                # for unconsumed text: the driver passes a text window of
                # exactly read length (cpu_baseline.cpp:466,516-517)
                span = (len(read.content) if alg in ("gact", "wfa",
                                                     "wfa_lm")
                        else 2 * len(read.content) + 64)
                text = genome.content[start : start + span]
                if alg == "exact":
                    ed, cg = exact_semiglobal(text, read.content)
                elif alg == "banded":
                    ed, cg = banded_semiglobal(text, read.content)
                elif alg == "wfa":
                    from ..cigar import edits_in_cigar
                    from ..wfa import wfa_global

                    _, cg = wfa_global(text, read.content)
                    ed = edits_in_cigar(cg)
                elif alg == "wfa_lm":
                    from ..wfa import wfa_distance

                    ed = wfa_distance(text, read.content,
                                      semiglobal=False)
                    cg = ""
                elif alg == "sw":
                    from ..baselines import local_affine
                    from ..cigar import edits_in_cigar

                    _, cg, _, _ = local_affine(text, read.content)
                    ed = edits_in_cigar(cg)
                elif alg == "gact":
                    from ..baselines import gact_tiled
                    from ..cigar import edits_in_cigar

                    cg = gact_tiled(text, read.content)
                    ed = edits_in_cigar(cg)
                elif alg == "edlib":
                    from ..baselines import edlib_semiglobal_cigar

                    ed, cg = edlib_semiglobal_cigar(text, read.content)
                else:
                    _, cg = affine_semiglobal(text, read.content)
                    from ..cigar import edits_in_cigar

                    ed = edits_in_cigar(cg)
                out.append(Alignment(cigar=cg, edit_distance=ed))
        core_ns = time.perf_counter_ns() - t0
        n = max(len(out), 1)
        return out, n * 1e9 / max(core_ns, 1)
    backend = {"genasm_device": "auto", "genasm_xla": "xla",
               "genasm_pyref": "pyref"}[alg]
    cfg = AlignConfig(backend=backend, batch_tile=tile)
    if backend == "pyref":
        t0 = time.perf_counter_ns()
        alns = api.align_reads(genome, reads, cfg)
        core_ns = time.perf_counter_ns() - t0
        return alns, len(alns) * 1e9 / max(core_ns, 1)
    alns, stats = api.align_reads(genome, reads, cfg, return_stats=True)
    return alns, stats.aligns_per_second


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = opt.scan_args(argv)

    bad = not opt.check_options(args, ALLOWED)
    verbose = opt.get_flag(args, "--verbose")[0] == opt.Opt.EXISTS
    accuracy = opt.get_flag(args, "--accuracy")[0] == opt.Opt.EXISTS
    print_cigar = opt.get_flag(args, "--cigar")[0] == opt.Opt.EXISTS
    st, threads_s = opt.get_value(args, "--threads", "2048")
    bad |= st == opt.Opt.INVALID
    st, algs_s = opt.get_value(args, "--algorithms", ",".join(ALL_ALGS))
    bad |= st == opt.Opt.INVALID
    st, scoring_s = opt.get_value(args, "--scoring", "2,4,4,2")
    bad |= st == opt.Opt.INVALID
    bad |= "--help" in args
    if bad:
        print(HELP_TEXT, end="")
        return 0

    tiles = [int(x) for x in threads_s.split(",") if x]
    algorithms = [a for a in algs_s.split(",") if a]
    unknown = [a for a in algorithms if a not in ALL_ALGS]
    if unknown:
        print(f"unknown algorithms: {unknown}", file=sys.stderr)
        return 1
    mat, sub, gapo, gape = (int(x) for x in scoring_s.split(","))
    api.enabled_algorithm_log = verbose

    genome, reads = _load(args)
    if verbose:
        print(f"{len(reads)} reads", file=sys.stderr)

    if accuracy and "wfa_lm" in algorithms:
        # wfa_lm is penalty-only (no CIGAR): a fabricated score=0 row
        # would be indistinguishable from a real score in the scraped
        # format; the reference has no wfa_lm accuracy adapter either
        print("wfa_lm skipped in --accuracy mode (no CIGAR)",
              file=sys.stderr)
        algorithms = [a for a in algorithms if a != "wfa_lm"]

    for tile in tiles:
        print(f"{tile} threads")
        for alg in algorithms:
            alns, aps = _align_with(alg, genome, reads, tile)
            if accuracy:
                pair_idx = 0
                for read in reads:
                    for loc in read.locations:
                        al = alns[pair_idx]
                        score = affine_score(al.cigar, mat, sub, gapo, gape)
                        line = f"pair_idx={pair_idx} score={score}"
                        if print_cigar:
                            start = loc.start_in_reference
                            ref_sub = genome.content[
                                start : start + len(read.content)]
                            line += (f" cigar={al.cigar} read={read.content}"
                                     f" reference={ref_sub}")
                        print(line)
                        pair_idx += 1
            else:
                print(f"{alg}: {aps:.2f} aligns/second")
        print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
