"""Multi-host scaling (jax.distributed) for read-mapping workloads.

The reference is strictly single-node (one GPU, genasm_gpu.cu:67; OpenMP on
one CPU). The scaling design here (SURVEY §5 / BASELINE north star):

 - every HOST holds the full reference genome (2-bit packed, a human
   genome is ~0.75 GiB — comfortably replicated in each device's memory),
 - reads + candidate locations are sharded across processes by pair index
   (embarrassingly parallel: zero inter-host communication in the steady
   state; the only collective is the optional result gather),
 - within each process, the existing single-host engine runs on the
   process-local devices.

Throughput therefore scales linearly with hosts up to input-distribution
bandwidth; scaling efficiency is measured by bench-style runs per process.

Usage (one process per host, standard jax.distributed environment):

    from scrooge_tpu.parallel import distributed as dist
    dist.initialize()                      # no-op if single-process
    alns = dist.align_reads_distributed(genome, reads, cfg)
    # every process returns the FULL result list when gather=True
    # (host-level allgather), or its local shard with global indices.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from ..config import AlignConfig
from ..datamodel import Alignment, Genome, Read


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Initialize jax.distributed; safe no-op for plain single-process
    runs. Called with no arguments it defers to jax's cluster
    auto-detection (SLURM / Open MPI / GKE environments), and
    only skips initialization when no cluster environment is detected —
    an argless call on a cluster node must NOT silently run
    single-process (every host would align the full dataset)."""
    import jax

    if num_processes is None and coordinator_address is None:
        try:
            from jax._src.clusters import ClusterEnv

            detected = ClusterEnv.auto_detect_unset_distributed_params(
                None, None, None, None, None, None)[0] is not None
        except Exception:  # private API moved: fall back to env sniffing
            import os

            detected = any(os.environ.get(v) for v in (
                "JAX_COORDINATOR_ADDRESS", "SLURM_JOB_ID",
                "OMPI_COMM_WORLD_SIZE"))
        if not detected:
            return  # no cluster environment: plain single-process run
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def _process_info() -> Tuple[int, int]:
    import jax

    return jax.process_index(), jax.process_count()


def shard_reads(reads: Sequence[Read],
                process_id: Optional[int] = None,
                process_count: Optional[int] = None
                ) -> Tuple[List[Read], List[int]]:
    """This process's read shard plus the global PAIR indices it owns.

    Pairs (read, candidate) are distributed round-robin by pair index so
    load stays balanced even when candidate counts vary per read.
    """
    pid, pcount = _process_info()
    if process_id is not None:
        pid = process_id
    if process_count is not None:
        pcount = process_count

    local_reads: List[Read] = []
    local_pair_idx: List[int] = []
    pair_idx = 0
    for read in reads:
        kept = [(pair_idx + i, loc)
                for i, loc in enumerate(read.locations)
                if (pair_idx + i) % pcount == pid]
        if kept:
            local_reads.append(Read(description=read.description,
                                    content=read.content,
                                    locations=[loc for _, loc in kept]))
            local_pair_idx.extend(gi for gi, _ in kept)
        pair_idx += len(read.locations)
    return local_reads, local_pair_idx


def align_reads_distributed(
    genome: Genome,
    reads: Sequence[Read],
    config: Optional[AlignConfig] = None,
    gather: bool = True,
):
    """Read-mapping across all processes; each aligns its pair shard.

    With gather=True every process returns the full, globally-ordered
    alignment list (host-level allgather of (edit_distance, cigar) pairs);
    otherwise returns (local_alignments, global_pair_indices).
    """
    from .. import api

    cfg = config or AlignConfig()
    pid, pcount = _process_info()
    local_reads, local_idx = shard_reads(reads)
    local_err = None
    try:
        local_alns = api.align_reads(genome, local_reads, cfg)
    except api.AlignmentError as e:
        if pcount == 1:
            raise
        # multi-process: do NOT die unilaterally — the other processes
        # are headed into the allgather collectives and would deadlock.
        # Participate in a failure-flag gather first so every process
        # raises consistently.
        local_err = str(e)
        local_alns = []
        local_idx = []

    if pcount > 1:
        import numpy as np
        from jax.experimental import multihost_utils as mhu

        ok = mhu.process_allgather(np.int64(local_err is None))
        if not bool(np.asarray(ok).all()):
            raise api.AlignmentError(
                local_err or "a peer process failed to align its shard "
                             "(see its log for the failing pair)")

    if not gather or pcount == 1:
        if gather:
            total = sum(len(r.locations) for r in reads)
            out: List[Optional[Alignment]] = [None] * total
            for idx, a in zip(local_idx, local_alns):
                out[idx] = a
            return out
        return local_alns, local_idx

    # host-level allgather of the ragged string results: agree on padded
    # shapes first (allgather requires identical shapes per process), then
    # gather (idx, ed, cigar-bytes) arrays
    import numpy as np
    from jax.experimental import multihost_utils as mhu

    local_n = len(local_alns)
    local_max_len = max((len(a.cigar) for a in local_alns), default=0)
    stats = mhu.process_allgather(
        np.array([local_n, local_max_len], np.int64))  # (pcount, 2)
    n_pad = int(stats[:, 0].max())
    len_pad = max(int(stats[:, 1].max()), 1)

    idx_arr = np.full(n_pad, -1, np.int64)
    ed_arr = np.zeros(n_pad, np.int64)
    len_arr = np.zeros(n_pad, np.int64)
    cig_arr = np.zeros((n_pad, len_pad), np.uint8)
    for k, (idx, a) in enumerate(zip(local_idx, local_alns)):
        idx_arr[k] = idx
        ed_arr[k] = a.edit_distance
        raw = a.cigar.encode("ascii")
        len_arr[k] = len(raw)
        cig_arr[k, : len(raw)] = np.frombuffer(raw, np.uint8)

    g_idx = mhu.process_allgather(idx_arr)
    g_ed = mhu.process_allgather(ed_arr)
    g_len = mhu.process_allgather(len_arr)
    g_cig = mhu.process_allgather(cig_arr)

    total = sum(len(r.locations) for r in reads)
    out: List[Optional[Alignment]] = [None] * total
    for p in range(g_idx.shape[0]):
        for k in range(g_idx.shape[1]):
            idx = int(g_idx[p, k])
            if idx < 0:
                continue
            raw = bytes(g_cig[p, k, : int(g_len[p, k])])
            out[idx] = Alignment(cigar=raw.decode("ascii"),
                                 edit_distance=int(g_ed[p, k]))
    return out
