"""Tools tests: converter, cigar analysis, dataset simulation, sweep CSVs."""

import csv
import os
import subprocess
import sys

import pytest

from scrooge_tpu.tools import convert as cv
from scrooge_tpu.tools.cigar_tools import (
    cigar_match_coords,
    cigar_path,
    correctly_aligned_fraction,
    maf_match_coords,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_convert_fasta_fastq_roundtrip(tmp_path):
    fa = tmp_path / "in.fa"
    fa.write_text(">r1 extra\nACGTN\nACGT\n>r2\nTTTT\n")
    reads = cv.import_reads(fa.read_text(), "FASTA")
    assert reads == [("r1 extra", "ACGTNACGT"), ("r2", "TTTT")]
    reads = cv.prune_titles(reads)
    assert reads[0][0] == "r1"
    kept = cv.restrict_reads(reads, "ACGT")
    assert [t for t, _ in kept] == ["r2"]
    fq = cv.export_reads(kept, "FASTQ")
    back = cv.import_reads(fq, "FASTQ")
    assert back == kept


def test_restrict_genome_splits():
    seqs = [("chr1", "ACGTNNACGTNA")]
    parts = cv.restrict_genome(seqs, "ACGT")
    assert parts == [("chr1_part0", "ACGT"), ("chr1_part1", "ACGT"),
                     ("chr1_part2", "A")]


def test_vgsim_import():
    reads = cv.import_reads("ACGT\nTTTT\n", "VGSIM")
    assert reads == [("read_000000", "ACGT"), ("read_000001", "TTTT")]


def test_cigar_path_and_match_coords():
    assert cigar_path("2=1I1D") == [(0, 0), (2, 2), (2, 3), (3, 3)]
    assert cigar_match_coords("2=1X1=") == {(0, 0), (1, 1), (3, 3)}


def test_correctly_aligned_fraction():
    #   ref : A C G T
    #   read: A C - T   (deletion of G)
    ref_row, read_row = "ACGT", "AC-T"
    # perfect cigar: 2= 1D 1=
    assert correctly_aligned_fraction("2=1D1=", ref_row, read_row) == 1.0
    # wrong cigar aligns T to the wrong column
    frac = correctly_aligned_fraction("2=1I1=", ref_row, read_row)
    assert frac < 1.0
    assert maf_match_coords(ref_row, read_row) == {(0, 0), (1, 1), (3, 2)}


def test_simulated_dataset_cli_and_sweep_smoke(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "scrooge_tpu.tools.download_datasets",
         "--simulate", "sim", "--num_reads", "4", "--read_len", "300",
         "--datasets_dir", str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert (tmp_path / "sim" / "candidates.paf").exists()

    from scrooge_tpu import io as sio

    genome, reads = sio.load_dataset(tmp_path / "sim")
    assert len(reads) == 4 and all(r.locations for r in reads)


def test_download_extract_via_local_server(tmp_path):
    """The Zenodo fetch path (scripts/download_datasets.py analogue)
    exercised for real: a 2-record dataset tarball served by a local
    http.server is downloaded, extracted into the profile.py layout
    contract, and loaded through the normal dataset loader — so the
    fetch/extract logic is tested code even on this air-gapped rig."""
    import functools
    import http.server
    import tarfile
    import threading

    from scrooge_tpu.tools.download_datasets import download

    genome = ("ACGTTGCAAGGCTTAC" * 8)
    r0, r1 = genome[0:40], genome[50:95]
    src = tmp_path / "src" / "tiny"
    src.mkdir(parents=True)
    (src / "reference.fasta").write_text(f">chr1\n{genome}\n")
    (src / "reads.fastq").write_text(
        f"@read0\n{r0}\n+\n{'I' * len(r0)}\n"
        f"@read1\n{r1}\n+\n{'I' * len(r1)}\n")
    (src / "candidates.paf").write_text(
        f"read0\t{len(r0)}\t0\t{len(r0)}\t+\tchr1\t{len(genome)}\t0\t"
        f"{len(r0)}\t{len(r0)}\t{len(r0)}\t60\n"
        f"read1\t{len(r1)}\t0\t{len(r1)}\t+\tchr1\t{len(genome)}\t50\t"
        f"{50 + len(r1)}\t{len(r1)}\t{len(r1)}\t60\n")
    srv_dir = tmp_path / "srv"
    srv_dir.mkdir()
    with tarfile.open(srv_dir / "scrooge_datasets.tar.gz", "w:gz") as tar:
        tar.add(src, arcname="tiny")

    handler = functools.partial(http.server.SimpleHTTPRequestHandler,
                                directory=str(srv_dir))
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        url = (f"http://127.0.0.1:{srv.server_address[1]}/"
               f"scrooge_datasets.tar.gz")
        dd = tmp_path / "datasets"
        assert download(str(dd), url) == 0
        assert not (dd / "datasets.tar.gz").exists()  # tarball cleaned up

        from scrooge_tpu import io as sio

        genome_t, reads = sio.load_dataset(dd / "tiny")
        assert genome_t.content == genome
        assert [r.content for r in reads] == [r0, r1]
        assert [r.locations[0].start_in_reference for r in reads] == [0, 50]
    finally:
        srv.shutdown()


def test_download_profile_via_local_server(tmp_path):
    """The published-profile fetcher (scripts/download_profile.py
    analogue) through the same local-server path: fetch, extract, tarball
    cleanup."""
    import functools
    import http.server
    import tarfile
    import threading

    from scrooge_tpu.tools.download_profile import download

    src = tmp_path / "src"
    src.mkdir()
    (src / "cpu_sweep.csv").write_text("W,O,aligns/second\n64,33,100.0\n")
    srv_dir = tmp_path / "srv"
    srv_dir.mkdir()
    with tarfile.open(srv_dir / "scrooge_profile.tar.gz", "w:gz") as tar:
        tar.add(src / "cpu_sweep.csv", arcname="published/cpu_sweep.csv")
    handler = functools.partial(http.server.SimpleHTTPRequestHandler,
                                directory=str(srv_dir))
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        url = (f"http://127.0.0.1:{srv.server_address[1]}/"
               f"scrooge_profile.tar.gz")
        pd = tmp_path / "profile"
        assert download(str(pd), url) == 0
        assert not (pd / "profile.tar.gz").exists()
        got = (pd / "published" / "cpu_sweep.csv").read_text()
        assert "64,33,100.0" in got
    finally:
        srv.shutdown()


def test_library_example_runs():
    """The reference ships a runnable library_example (library_example.cu)
    — ours must keep running through the public API (CPU backends)."""
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples",
                                      "library_example.py")],
        capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "edit_distance" in proc.stdout or "=" in proc.stdout


def test_asic_model_matches_reference_linear_numbers():
    """The analytical vault model must reproduce the reference's linear
    (non-CACTI) improvement factors (asic_numbers.py improvements)."""
    from scrooge_tpu.profiling.model import area, power

    ga, sa = area(64, 33, 64, False, False), area(64, 33, 64, True, True)
    gp, sp = power(64, 33, 64, False, False), power(64, 33, 64, True, True)
    assert round(sum(ga) / sum(sa), 3) == 3.326
    assert round(sum(gp) / sum(sp), 3) == 1.974


def test_asic_latency_model():
    from scrooge_tpu.profiling.model import single_window_latency

    # W=64, O=33, 64 PEs: (2*64+1)*1 + 31 = 160 cycles
    assert single_window_latency(64, 33, 64) == 160
    # 32 PEs: two blocks
    assert single_window_latency(64, 33, 32) == (129 * 2) + 31


def test_simulated_truth_and_dataset_roundtrip(tmp_path):
    """with_truth must not perturb the RNG stream, its gapped rows must
    reproduce the read and the genome segment, and write_dataset must
    materialize the reference's dataset-directory contract including a
    gapped MAF that maf_truth_rows parses back verbatim."""
    from scrooge_tpu.io import load_dataset
    from scrooge_tpu.tools.cigar_tools import maf_truth_rows
    from scrooge_tpu.utils.simulate import simulate_dataset, write_dataset

    ds0 = simulate_dataset(genome_len=5000, num_reads=4, read_len=300,
                           seed=5)
    ds = simulate_dataset(genome_len=5000, num_reads=4, read_len=300,
                          seed=5, with_truth=True)
    assert [r.content for r in ds0.reads] == [r.content for r in ds.reads]
    for i, read in enumerate(ds.reads):
        ref_row, read_row = ds.truth[i]
        assert read_row.replace("-", "") == read.content
        st = read.locations[0].start_in_reference
        ref_flat = ref_row.replace("-", "")
        assert ds.genome.content[st : st + len(ref_flat)] == ref_flat

    out = tmp_path / "sim_ds"
    write_dataset(ds, out)
    genome, reads = load_dataset(out)
    assert genome.content == ds.genome.content
    assert [r.content for r in reads] == [r.content for r in ds.reads]
    assert [r.locations[0].start_in_reference for r in reads] == \
        [r.locations[0].start_in_reference for r in ds.reads]
    assert maf_truth_rows(str(out / "candidates.maf")) == ds.truth


def test_simulated_chained_decoys():
    """decoys>0 = the chained candidate model (pbsim_chained family):
    extra wrong candidates appended after the true one, read content
    bit-identical to the groundtruth model at the same seed, and the
    device path must still return bit-exact results for every candidate
    (wrong ones route through the batched retry)."""
    import scrooge_tpu
    from scrooge_tpu import AlignConfig
    from scrooge_tpu.utils.simulate import simulate_dataset

    base = simulate_dataset(genome_len=50_000, num_reads=12, read_len=400,
                            seed=9)
    ch = simulate_dataset(genome_len=50_000, num_reads=12, read_len=400,
                          seed=9, decoys=1.5)
    assert [r.content for r in base.reads] == [r.content for r in ch.reads]
    n_locs = sum(len(r.locations) for r in ch.reads)
    assert n_locs > 12  # decoys actually appended
    assert all(r.locations[0].start_in_reference
               == b.locations[0].start_in_reference
               for r, b in zip(ch.reads, base.reads))

    from scrooge_tpu import pyref

    cfg = AlignConfig(backend="xla", batch_tile=128)
    got = scrooge_tpu.align_all(ch.genome, ch.reads, config=cfg)
    assert len(got) == n_locs
    i = 0
    ref_cfg = AlignConfig()
    for read in ch.reads:
        for loc in read.locations:
            ed, cigar = pyref.align_pair(
                ch.genome.content[loc.start_in_reference:], read.content,
                ref_cfg)
            assert (got[i].edit_distance, got[i].cigar) == (ed, cigar)
            i += 1
