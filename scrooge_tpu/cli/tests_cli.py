"""`tests` binary analogue: unit tests + performance tests from the CLI.

Mirrors /root/reference/src/tests.cu (flags: tests.cu:726-765; unit tests:
tests.cu:782-816; perf tests: tests.cu:335-487) with the device axis
replacing the CPU/GPU axis:

  python -m scrooge_tpu.cli.tests_cli --unit_tests
  python -m scrooge_tpu.cli.tests_cli --reference=... --reads=... --seeds=...
  python -m scrooge_tpu.cli.tests_cli --cpu_performance_test ...   (XLA engine)

Output formats are API: profiling tooling scrapes the "ran at N
aligns/second" lines (profile.py:55-63 analogue).
"""

from __future__ import annotations

import sys
import time
from typing import List

from .. import api
from ..config import AlignConfig
from ..datamodel import CandidateLocation, Genome, Read
from ..cigar import CigarError, validate_cigar
from . import options as opt

HELP_TEXT = """\
python -m scrooge_tpu.cli.tests_cli [options]
Options:
--reference=[path to reference FASTA] -- override default reference data for performance test
--reads=[path to reads FASTQ]         -- override default reads data for performance test
--seeds=[path to MAF or PAF]          -- override default seeds data for performance test
--device_info_only                    -- only print device info
--verbose                             -- print progress to stderr. Otherwise, only test results are printed
--unit_tests                          -- run unit tests (default: disabled)
--cpu_performance_test                -- run the portable XLA-engine performance test (default: the device engine)
--profile=[trace dir]                 -- capture a jax.profiler trace of the performance run
--simulated=[N[,LEN]]                 -- use a built-in simulated dataset instead of files
--read_length_cap=[N]                 -- truncate every read to N characters (tests.cu:361-365)
--dataset_inflation=[N]               -- duplicate the read set N times (tests.cu:367-373)
--help                                -- displays this information
"""

ALLOWED = ["--reference", "--reads", "--seeds", "--device_info_only",
           "--verbose", "--unit_tests", "--cpu_performance_test",
           "--profile", "--simulated", "--read_length_cap",
           "--dataset_inflation", "--help"]

# Golden cases from the reference kernel unit tests (tests.cu:183-196):
# 9 handcrafted reads against a 16bp reference, expected edit distances
# {8, 0, 3, 8, 12, 6, 8, 0, 48}, incl. empty/oversized/len-64 boundary.
GOLDEN_REFERENCE = "AAAACCCCGGGGTTTT"
GOLDEN_READS = [
    ("test_read_4d12m4i", "CCCCGGGGTTTTAAAA"),
    ("test_read_16m", "AAAACCCCGGGGTTTT"),
    ("test_read_3d7m", "ACCCCGG"),
    ("test_read_4m4d4m4i4m", "AAAAGGGGAAAATTTT"),
    ("test_read_12s4m", "AAAAAAAAAAAAAAAA"),
    ("test_read_1m1s1i3m1s2m3i", "ATTAACGCCTTT"),
    ("test_read_oversized", "TTTTAAAACCCCGGGGTTTTAAAA"),
    ("test_read_empty", ""),
    ("test_read_len64",
     "TTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTAAAACCCCGGGGTTTTAAAA"),
]
GOLDEN_DISTANCES = [8, 0, 3, 8, 12, 6, 8, 0, 48]


def print_device_info():
    import jax

    devices = jax.devices()
    print(f"{len(devices)} visible device(s):")
    for i, d in enumerate(devices):
        print(f'idx={i} name="{d.device_kind}" platform={d.platform}')
    print()


def _golden_genome_reads():
    genome = Genome(content=GOLDEN_REFERENCE)
    loc = CandidateLocation(start_in_reference=0, start_in_chromosome=0,
                            strand=True, chromosome="")
    reads = [Read(description=d, content=c, locations=[loc])
             for d, c in GOLDEN_READS]
    return genome, reads


def _engine_correctness_test(name: str, cfg: AlignConfig) -> bool:
    genome, reads = _golden_genome_reads()
    alignments = api.align_all(genome, reads, config=cfg)
    if len(alignments) != len(GOLDEN_DISTANCES):
        print(f"FAILED {name}: align_all() produced wrong number of "
              "alignments")
        return False
    success = True
    for i, (a, want) in enumerate(zip(alignments, GOLDEN_DISTANCES)):
        if a.edit_distance != want:
            print(f"FAILED {name}: align_all() produced distance "
                  f"{a.edit_distance} instead of {want} for read "
                  f'"{reads[i].description}"')
            success = False
        try:
            validate_cigar(a.cigar, a.edit_distance, GOLDEN_REFERENCE,
                           reads[i].content, 0)
        except CigarError as e:
            print(f"FAILED {name}: {e} for read \"{reads[i].description}\"")
            success = False
    if success:
        print(f"PASSED {name}")
    return success


def bitvector_tests() -> bool:
    """Bitvector primitive unit tests on an awkward 65-bit configuration
    (bitvector_test.cu:5-130 analogue, on the uint32-lane bitvector)."""
    import numpy as np

    from ..ops import bitvec as bv

    W = 65
    ok = True
    rng = np.random.default_rng(0)
    for _ in range(50):
        val = int(rng.integers(0, 2)) and rng.integers(0, 1 << 63)
        val = int(val) | (int(rng.integers(0, 2)) << 64)
        nw = bv.num_words(W)
        words = np.array([(val >> (32 * w)) & 0xFFFFFFFF for w in range(nw)],
                         np.uint32).reshape(nw, 1)
        import jax.numpy as jnp
        v = jnp.asarray(words)
        # shift left by 1 with top-word masking
        got = np.asarray(bv.shl1(v, W)).reshape(nw)
        want = (val << 1) & ((1 << W) - 1)
        got_int = sum(int(g) << (32 * w) for w, g in enumerate(got))
        if got_int != want:
            print(f"FAILED bitvector shl1: {val:#x} -> {got_int:#x}, "
                  f"want {want:#x}")
            ok = False
        # ones_shifted
        sh = int(rng.integers(0, W + 2))
        got = np.asarray(bv.ones_shifted(jnp.full((1,), sh, jnp.int32), W))
        got_int = sum(int(g[0]) << (32 * w) for w, g in enumerate(got))
        want = (((1 << W) - 1) << sh) & ((1 << W) - 1)
        if got_int != want:
            print(f"FAILED bitvector ones_shifted({sh}): {got_int:#x}, "
                  f"want {want:#x}")
            ok = False
        # bit test
        bit = int(rng.integers(0, W))
        got0 = bool(np.asarray(bv.bit_is_zero(
            v, jnp.full((1,), bit, jnp.int32)))[0])
        if got0 != (((val >> bit) & 1) == 0):
            print(f"FAILED bitvector bit_is_zero({bit}) on {val:#x}")
            ok = False
    if ok:
        print("PASSED bitvector_tests")
    return ok


def packing_correctness_test() -> bool:
    """2-bit packing parity with a scalar model (tests.cu:582-647 analogue,
    incl. empty and non-multiple-of-word lengths)."""
    import numpy as np
    import jax.numpy as jnp

    from ..ops.engine_pallas import pack_2bit

    ok = True
    rng = np.random.default_rng(1)
    for length in [0, 1, 3, 15, 16, 17, 31, 33, 100]:
        codes = rng.integers(0, 4, (1, length), dtype=np.uint8)
        got = np.asarray(pack_2bit(jnp.asarray(codes)))[0]
        want = np.zeros(max(-(-length // 16), 0), np.uint32)
        for k in range(length):
            want[k // 16] |= np.uint32(int(codes[0, k]) << (2 * (k % 16)))
        if not np.array_equal(got, want):
            print(f"FAILED packing_correctness_test at length {length}")
            ok = False
    if ok:
        print("PASSED packing_correctness_test")
    return ok


def library_interface_correctness_test() -> bool:
    """All interfaces/backends must produce identical alignments
    (tests.cu:273-333 analogue; compares DISTANCES and CIGARs — the
    reference accidentally compared CIGARs twice, tests.cu:310-313)."""
    import random

    rng = random.Random(7)
    texts, queries = [], []
    for _ in range(8):
        t = "".join(rng.choice("ACGT") for _ in range(100))
        q = "".join(c for c in t if rng.random() > 0.05)
        texts.append(t)
        queries.append(q or "A")

    results = {}
    for backend in ("pyref", "xla"):
        cfg = AlignConfig(backend=backend, batch_tile=128)
        pair = api.align_pairs(texts, queries, cfg)
        mapped = []
        for t, q in zip(texts, queries):
            genome = Genome(content=t)
            read = Read(description="r", content=q,
                        locations=[CandidateLocation(start_in_reference=0)])
            mapped.append(api.align_reads(genome, [read], cfg)[0])
        results[backend] = (pair, mapped)

    ok = True
    base_pair, base_mapped = results["pyref"]
    for backend, (pair, mapped) in results.items():
        for i in range(len(texts)):
            for got in (pair[i], mapped[i]):
                if got.edit_distance != base_pair[i].edit_distance:
                    print(f"FAILED library_interface_correctness_test: "
                          f"distances disagree ({backend}, pair {i})")
                    ok = False
                if got.cigar != base_pair[i].cigar:
                    print(f"FAILED library_interface_correctness_test: "
                          f"cigars disagree ({backend}, pair {i})")
                    ok = False
    if ok:
        print("PASSED library_interface_correctness_test")
    return ok


def performance_test(reference_file: str, reads_file: str, seeds_file: str,
                     cfg: AlignConfig, device_name: str,
                     profile_dir: str = None, simulated: str = None,
                     read_length_cap: int = -1,
                     dataset_inflation: int = 1) -> None:
    """Performance run over a dataset directory's files
    (tests.cu:335-487 analogue: filter reverse strands, sort by length
    descending, align, CIGAR-validate every pair, print timing lines)."""
    from .. import io as sio

    log = api.enabled_algorithm_log

    def vlog(msg):
        if log:
            print(msg, file=sys.stderr)

    vlog("Starting performance test...")
    if simulated is not None:
        from ..utils.simulate import simulate_dataset

        parts = (simulated or "").split(",")
        num = int(parts[0]) if parts[0] else 256
        rlen = int(parts[1]) if len(parts) > 1 else 2000
        ds = simulate_dataset(genome_len=500_000, num_reads=num,
                              read_len=rlen, accuracy=0.95, seed=13)
        genome, reads = ds.genome, ds.reads
    else:
        import os

        if (reference_file == "datasets/default/reference.fasta"
                and not os.path.exists(reference_file)):
            # default invocation with no downloaded data: materialize a
            # simulated default dataset once (reference.fasta +
            # reads.fastq + ground-truth candidates.maf) so the binary
            # analogue runs as shipped (tests.cu's defaults assume the
            # Zenodo datasets; this rig is air-gapped)
            from ..utils.simulate import simulate_dataset, write_dataset

            print("default dataset missing; simulating one under "
                  "datasets/default (PBSIM2-style 1024x10kbp reads)",
                  file=sys.stderr)
            write_dataset(simulate_dataset(num_reads=1024, with_truth=True),
                          "datasets/default")
        vlog("Reading reference sequence...")
        genome = sio.read_genome(reference_file)
        vlog("Reading reads files...")
        reads = sio.read_fastq_and_seed_locations(genome, reads_file,
                                                  seeds_file)

    vlog("Filtering reads...")
    for read in reads:
        read.locations = [l for l in read.locations if l.strand]

    # workload-shaping knobs (tests.cu:361-373): truncate reads, then
    # duplicate the read set to inflate the dataset
    if read_length_cap >= 0:
        for read in reads:
            read.content = read.content[:read_length_cap]
    if dataset_inflation > 1:
        base = list(reads)
        for _ in range(dataset_inflation - 1):
            reads.extend(base)

    vlog("Sorting reads...")
    reads.sort(key=lambda r: -len(r.content))

    vlog("Running alignment algorithm...")
    if profile_dir:
        # device+host trace for external analysis (the reference relies on
        # nvcc -lineinfo + external profilers, Makefile:9; here the JAX
        # profiler writes a TensorBoard/XProf trace)
        import jax

        with jax.profiler.trace(profile_dir):
            t0 = time.perf_counter_ns()
            alignments, stats = api.align_reads(genome, reads, cfg,
                                                return_stats=True)
            end_to_end_ns = time.perf_counter_ns() - t0
        vlog(f"profiler trace written to {profile_dir}")
    else:
        t0 = time.perf_counter_ns()
        alignments, stats = api.align_reads(genome, reads, cfg,
                                            return_stats=True)
        end_to_end_ns = time.perf_counter_ns() - t0

    vlog("Sanity checking alignments...")
    pair_idx = 0
    for read in reads:
        for loc in read.locations:
            a = alignments[pair_idx]
            try:
                validate_cigar(a.cigar, a.edit_distance, genome.content,
                               read.content, loc.start_in_reference)
            except CigarError:
                print("FAILED sanity check in algorithm_performance_test "
                      f"for alignment {pair_idx}")
            pair_idx += 1
    vlog("Done")

    n = max(len(alignments), 1)
    print(f"align_all() took {end_to_end_ns // 1_000_000}ms (data "
          "transfers, conversion, kernel and post-processing)")
    print(f"{device_name} kernel took {stats.core_ns // 1_000_000}ms")
    print(f"{device_name} kernel ran at "
          f"{n * 1_000_000_000 // max(stats.core_ns, 1)} aligns/second")


def main(argv: List[str] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = opt.scan_args(argv)

    reference_file = "datasets/default/reference.fasta"
    reads_file = "datasets/default/reads.fastq"
    seeds_file = "datasets/default/candidates.maf"

    bad = not opt.check_options(args, ALLOWED)
    device_info_only = opt.get_flag(args, "--device_info_only")[0]
    verbose = opt.get_flag(args, "--verbose")[0]
    unit_tests = opt.get_flag(args, "--unit_tests")[0]
    cpu_perf = opt.get_flag(args, "--cpu_performance_test")[0]
    for flag in (device_info_only, verbose, unit_tests, cpu_perf):
        bad |= flag == opt.Opt.INVALID
    st, reference_file = opt.get_value(args, "--reference", reference_file)
    bad |= st == opt.Opt.INVALID
    st, reads_file = opt.get_value(args, "--reads", reads_file)
    bad |= st == opt.Opt.INVALID
    st, seeds_file = opt.get_value(args, "--seeds", seeds_file)
    bad |= st == opt.Opt.INVALID
    st, profile_dir = opt.get_value(args, "--profile", None)
    bad |= st == opt.Opt.INVALID
    st, simulated = opt.get_value(args, "--simulated")
    simulated = simulated if st == opt.Opt.VALUE else None
    bad |= st == opt.Opt.INVALID
    st, cap_s = opt.get_value(args, "--read_length_cap", "-1")
    bad |= st == opt.Opt.INVALID
    st, infl_s = opt.get_value(args, "--dataset_inflation", "1")
    bad |= st == opt.Opt.INVALID
    try:
        read_length_cap, dataset_inflation = int(cap_s), int(infl_s)
    except ValueError:
        bad = True
        read_length_cap, dataset_inflation = -1, 1
    bad |= "--help" in args

    if bad:
        print(HELP_TEXT, end="")
        return 0

    if device_info_only == opt.Opt.EXISTS:
        print_device_info()
        return 0

    api.enabled_algorithm_log = verbose == opt.Opt.EXISTS

    if unit_tests == opt.Opt.EXISTS:
        print_device_info()
        ok = bitvector_tests()
        ok &= packing_correctness_test()
        ok &= _engine_correctness_test(
            "xla_algorithm_correctness_test",
            AlignConfig(backend="xla", batch_tile=128))
        ok &= _engine_correctness_test(
            "device_algorithm_correctness_test",
            AlignConfig(backend="auto", batch_tile=128))
        ok &= library_interface_correctness_test()
        return 0 if ok else 1

    if cpu_perf == opt.Opt.EXISTS:
        cfg = AlignConfig(backend="xla")
        performance_test(reference_file, reads_file, seeds_file, cfg, "XLA",
                         profile_dir, simulated, read_length_cap,
                         dataset_inflation)
    else:
        import jax

        print_device_info()
        cfg = AlignConfig(backend="auto")
        performance_test(reference_file, reads_file, seeds_file, cfg,
                         jax.devices()[0].platform.upper(),
                         profile_dir, simulated, read_length_cap,
                         dataset_inflation)
    return 0


if __name__ == "__main__":
    sys.exit(main())
