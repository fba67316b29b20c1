"""scrooge_tpu — GenASM/Scrooge pairwise sequence aligner in JAX/Pallas.

A from-scratch JAX/Pallas reimplementation of the capabilities of
CMU-SAFARI/Scrooge: the GenASM bitvector approximate string-matching
algorithm (semiglobal edit distance + extended CIGAR), W-wide overlapping
windows for arbitrary-length reads, the SENE/DENT/ET optimizations, both
library interfaces (unstructured pairwise, and read-mapping against a
shared reference genome with candidate locations), plus the surrounding
I/O, testing, profiling, and multi-device scaling machinery. The device
path runs on NVIDIA GPUs; the same code runs on the CPU for tests.
"""

from .utils import xla_workarounds as _xla_workarounds

_xla_workarounds.apply()

from .config import AlignConfig
from .datamodel import Alignment, CandidateLocation, Genome, Read
from .api import align_all, align_pairs, align_reads

__version__ = "0.1.0"

__all__ = [
    "AlignConfig",
    "Alignment",
    "CandidateLocation",
    "Genome",
    "Read",
    "align_all",
    "align_pairs",
    "align_reads",
]
