"""Multi-host sharding logic tests (single-process semantics + shard math).

True multi-host runs need a jax.distributed cluster; here we validate the
pair-sharding arithmetic for arbitrary process counts and the end-to-end
single-process path (which the multi-host path reduces to per process).
"""

import random

import scrooge_tpu
from scrooge_tpu import AlignConfig, CandidateLocation, Genome, Read
from scrooge_tpu.parallel import distributed as dist


def _mk_reads(n, with_multi_locs=True):
    rng = random.Random(1)
    reads = []
    for i in range(n):
        content = "".join(rng.choice("ACGT") for _ in range(60))
        locs = [CandidateLocation(start_in_reference=0)]
        if with_multi_locs and i % 3 == 0:
            locs.append(CandidateLocation(start_in_reference=4))
        reads.append(Read(description=f"r{i}", content=content,
                          locations=locs))
    return reads


def test_shard_reads_partition_complete_and_disjoint():
    reads = _mk_reads(17)
    total = sum(len(r.locations) for r in reads)
    seen = []
    for pid in range(4):
        _, idxs = dist.shard_reads(reads, process_id=pid, process_count=4)
        seen.extend(idxs)
        # round-robin: every index owned by exactly its pid
        assert all(i % 4 == pid for i in idxs)
    assert sorted(seen) == list(range(total))


def test_shard_load_balance():
    reads = _mk_reads(100)
    total = sum(len(r.locations) for r in reads)
    counts = [len(dist.shard_reads(reads, process_id=p, process_count=8)[1])
              for p in range(8)]
    assert sum(counts) == total
    assert max(counts) - min(counts) <= 1


def test_single_process_distributed_matches_direct():
    rng = random.Random(5)
    genome_str = "".join(rng.choice("ACGT") for _ in range(2000))
    genome = Genome(content=genome_str)
    reads = []
    for i in range(12):
        start = rng.randint(0, 1500)
        content = genome_str[start : start + 120]
        reads.append(Read(description=f"r{i}", content=content,
                          locations=[CandidateLocation(
                              start_in_reference=start)]))
    cfg = AlignConfig(backend="xla", batch_tile=128)

    direct = scrooge_tpu.align_all(genome, reads, config=cfg)
    dist.initialize()  # single-process no-op
    via_dist = dist.align_reads_distributed(genome, reads, cfg)
    assert len(direct) == len(via_dist)
    for a, b in zip(direct, via_dist):
        assert (a.edit_distance, a.cigar) == (b.edit_distance, b.cigar)

def test_two_process_allgather_end_to_end(tmp_path):
    """REAL 2-process jax.distributed run (CPU + gloo collectives): both
    workers align their round-robin shard of one deterministic dataset,
    allgather, and must each hold the full result list — identical to a
    direct single-process alignment (the multi-process CPU simulation
    SURVEY §4.8 calls for)."""
    import json
    import os
    import socket
    import subprocess
    import sys

    import pytest

    from scrooge_tpu.utils.simulate import simulate_dataset

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="",  # fresh single-device CPU workers
               PYTHONPATH=repo_root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    worker = os.path.join(os.path.dirname(__file__), "dist_worker.py")
    outs = [str(tmp_path / f"out{p}.json") for p in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, worker, str(p), "2", str(port), outs[p]],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for p in range(2)]
    try:
        for p in procs:
            p.wait(timeout=300)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.skip("distributed workers timed out (no gloo support?)")
    if any(p.returncode != 0 for p in procs):
        errs = [p.stderr.read().decode()[-500:] for p in procs]
        pytest.fail(f"worker failed: {errs}")

    results = [json.load(open(o)) for o in outs]
    assert results[0] == results[1]
    ds = simulate_dataset(genome_len=20_000, num_reads=24, read_len=300,
                          seed=17)
    direct = scrooge_tpu.align_all(
        ds.genome, ds.reads, config=AlignConfig(backend="xla",
                                                batch_tile=128))
    assert results[0] == [[a.edit_distance, a.cigar] for a in direct]


def test_distributed_scaling_harness(tmp_path):
    """The multi-host measurement harness (scaling --distributed) must
    complete a real 1- and 2-process jax.distributed run and write the
    efficiency CSV — the one-command path to the >=80%-at-2-hosts
    BASELINE.json measurement when real multi-host hardware exists. On
    this shared-CPU host the efficiency number itself only measures core
    contention, so only its presence/shape is asserted."""
    import csv as _csv

    from scrooge_tpu.profiling import scaling

    out = tmp_path / "scaling_dist.csv"
    rc = scaling.main(["--distributed", "2", "--per_process", "256",
                       "--read_len", "200", "--out", str(out)])
    assert rc == 0
    with open(out) as f:
        rows = list(_csv.DictReader(f))
    assert [int(r["processes"]) for r in rows] == [1, 2]
    for r in rows:
        assert float(r["aligns_per_second"]) > 0
        assert 0 < float(r["weak_scaling_efficiency"]) <= 1.2
    assert int(rows[1]["total_pairs"]) == 512
