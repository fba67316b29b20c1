"""Algorithm configuration ("knobs").

The reference exposes its knobs as compile-time C preprocessor macros
(W, K, O, STORE_ENTRIES_NOT_EDGES, DISCARD_ENTRIES_NOT_USED_BY_TRACEBACK,
EARLY_TERMINATION; see /root/reference/src/genasm_cpu.cpp:1-35) and
recompiles the binary per configuration (scripts/profile.py:28-33).

Here they are runtime parameters: a frozen dataclass that is hashable so it
can be passed as a static argument to ``jax.jit`` — changing a knob triggers
a re-trace/re-compile (the XLA analogue of the reference's recompile-per-
config sweep), while keeping a single Python binary.

Semantics notes (mirroring the reference):
 - ``W``: window width (text and pattern chunk size per DP window).
 - ``K``: maximum edit distance searched per window (DP rows = K+1).
 - ``O``: window overlap; only the first ``W - O`` text/pattern characters
   of each window's traceback are kept (TB_LIMIT, genasm_cpu.cpp:50).
 - ``store_entries_not_edges`` (SENE) and
   ``discard_entries_not_used_by_traceback`` (DENT) change memory layout
   only; outputs are bit-identical either way. The device engines always
   store entries (SENE) and always discard non-traceback bits (DENT)
   because that is strictly less memory with no downside; the flags are accepted for sweep compatibility and
   exercised in the Python oracle.
 - ``early_termination`` (ET) stops the DP d-loop at the first row whose
   i==0 entry signals a full-pattern match. Output-invariant; purely a
   performance toggle. On the device it is a *batched* early exit: the
   d-loop stops once every lane of a warp (kernel) or of the tile
   (engine_xla) has found its distance.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class AlignConfig:
    """Runtime equivalent of the reference's compile-time knob block."""

    W: int = 64
    K: int = 64
    O: int = 33

    # Scrooge optimization toggles (output-invariant; see module docstring).
    store_entries_not_edges: bool = True
    discard_entries_not_used_by_traceback: bool = True
    early_termination: bool = True

    # Device execution knobs (no reference analogue; tile sizing replaces
    # the GPU's THREAD_BLOCKS_PER_SM / persistent-block work queue,
    # genasm_gpu.cu:583-629).
    batch_tile: int = 1024  # pairs per device tile (a multiple of 128)
    backend: str = "auto"  # "auto" | "xla" | "pallas" | "pyref"
    # Run the Pallas kernel in the Pallas interpreter instead of compiling
    # it for the GPU: how the tests exercise the kernel without a card.
    interpret: bool = False
    # Kernel per-window d-search cap override (see tb_cap below); 0 = auto
    # (min(K, 32)). Raising it trades R-table rows + fill iterations for
    # fewer retried lanes on high-error (ONT-like) inputs.
    tb_cap_override: int = 0
    # retry escalation: lanes that fail for a kernel-resolvable reason
    # (tb_cap exceeded, compaction-cap overflow) re-run on the kernel with
    # the cap doubled before falling to the full-K XLA retry.
    # Output-invariant (the ladder ends at full coverage either way);
    # purely a retry-path performance policy.
    retry_escalation: bool = True

    def __post_init__(self):
        if self.W < 2:
            raise ValueError("W must be >= 2")
        if not (0 <= self.O < self.W):
            raise ValueError("O must satisfy 0 <= O < W")
        if self.K < 1:
            raise ValueError("K must be >= 1")
        if self.batch_tile % 128 != 0:
            raise ValueError("batch_tile must be a multiple of 128")
        if not 0 <= self.tb_cap_override <= self.K:
            raise ValueError("tb_cap_override must be in [0, K]")

    # ---- derived quantities (names follow genasm_cpu.cpp:44-84) ----

    @property
    def tb_limit(self) -> int:
        """Max text/pattern chars traced back per window (W - O)."""
        return self.W - self.O

    @property
    def columns(self) -> int:
        """Columns of the stored R table: W-O+1 (DENT always on device)."""
        return self.W - self.O + 1

    @property
    def rows(self) -> int:
        return self.K + 1

    @property
    def tb_cap(self) -> int:
        """Device-engine cap on per-window edit distance (kernel engine
        only): DP rows stored for traceback and d-levels searched. A
        window that finds no alignment within tb_cap edits fails its lane
        to the bit-exact batched-XLA/scalar retry path — at min(K, 32)
        that is unreachable for realistic read accuracies (P[window edit
        distance > 32] < 1e-9 even at 80% accuracy) while keeping the R
        table and the traceback-row buffers small. ``tb_cap_override``
        raises/lowers it explicitly (the retry-cliff knob for high-error
        inputs; swept by profiling/sweep.py). The XLA engine always
        searches the full K (it is the fallback the retry path relies
        on)."""
        if self.tb_cap_override:
            return min(self.tb_cap_override, self.K)
        return min(self.K, 32)

    @property
    def num_words(self) -> int:
        """uint32 words per full-width bitvector."""
        return (self.W + 31) // 32

    @property
    def first_tb_word(self) -> int:
        """First full-vector word kept in the stored R entry.

        In the MSB-aligned space the traceback reads bits W-1-j and
        W-1-(j+1) for j < tb_limit, i.e. bits [O-1, W); stored entries
        keep the words covering that range.
        """
        return max(self.O - 1, 0) // 32

    @property
    def num_tb_words(self) -> int:
        """uint32 words per stored (traceback-truncated) R entry."""
        return self.num_words - self.first_tb_word

    def max_windows(self, max_read_len: int) -> int:
        """Static bound on the number of DP windows for a read length.

        A window consumes up to tb_limit pattern chars, but fewer when
        deletions advance the text cursor to tb_limit first — so we budget
        ~34% headroom (sufficient up to ~25% deletion rate) plus slack.
        Lanes that still run out are flagged failed and the API retries
        them (lanes that stall entirely — pathological inputs the
        reference would infinite-loop on, genasm_cpu.cpp:416-435 — are
        flagged failed permanently).
        """
        if max_read_len <= 0:
            return 1
        return int(math.ceil(max_read_len * 1.34 / max(1, self.tb_limit))) + 4

    # Max traceback path steps per window: each step consumes a text or
    # pattern char (or both); i and j are both bounded by tb_limit, and j
    # additionally by m<=W.  (<= 2*tb_limit when O>0; W when O==0.)
    @property
    def max_tb_steps(self) -> int:
        return 2 * max(self.tb_limit, 1)
