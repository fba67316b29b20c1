"""Minimal usage demo of the library interfaces.

Analogue of /root/reference/src/library_example.cu:11-98: exercises the
unstructured string-pairs interface and the read-mapping interface
(backend="auto" runs the Pallas window kernel on a GPU and the portable
XLA engine elsewhere).

Run: python examples/library_example.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))
# persistent compile cache (first run compiles; later runs start hot)
_cache = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      os.pardir, ".jax_cache")
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", _cache)
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "0")

import scrooge_tpu
from scrooge_tpu import AlignConfig, CandidateLocation, Genome, Read


def string_pairs_example(backend: str):
    texts = ["AAAACCCCGGGGTTTT", "GATTACAGATTACA"]
    queries = ["CCCCGGGGTTTTAAAA", "GATTACAGATTACA"]
    cfg = AlignConfig(backend=backend, batch_tile=128)
    alignments = scrooge_tpu.align_all(texts, queries, config=cfg)
    print(f"[{backend}] string pairs:")
    for q, a in zip(queries, alignments):
        print(f"  {q}: edit_distance={a.edit_distance} cigar={a.cigar}")


def read_mapping_example(backend: str):
    genome = Genome(content="AAAACCCCGGGGTTTT" * 4,
                    chromosome_starts={"chr1": 0})
    reads = [
        Read(description="read1", content="CCCCGGGGTTTTAAAA",
             locations=[CandidateLocation(read_description="read1",
                                          chromosome="chr1",
                                          start_in_reference=4)]),
        Read(description="read2", content="AAAACCCC",
             locations=[CandidateLocation(read_description="read2",
                                          chromosome="chr1",
                                          start_in_reference=0),
                        CandidateLocation(read_description="read2",
                                          chromosome="chr1",
                                          start_in_reference=16)]),
    ]
    cfg = AlignConfig(backend=backend, batch_tile=128)
    alignments = scrooge_tpu.align_all(genome, reads, config=cfg)
    print(f"[{backend}] read mapping (one alignment per candidate):")
    idx = 0
    for read in reads:
        for loc in read.locations:
            a = alignments[idx]
            print(f"  {read.description}@{loc.start_in_reference}: "
                  f"edit_distance={a.edit_distance} cigar={a.cigar}")
            idx += 1


if __name__ == "__main__":
    for backend in ("xla", "auto"):
        string_pairs_example(backend)
        read_mapping_example(backend)
