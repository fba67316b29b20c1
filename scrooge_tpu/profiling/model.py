"""Analytical area/power/throughput model (asic_numbers.py analogue).

**ASIC vault model** — the reference's analytical model of a GenASM-
   style accelerator (scripts/asic_numbers.py:75-295), reimplemented:
   per-window latency (2W+1 DC cycles per PE-block + W-O TB cycles),
   TB-SRAM sizing under the four SENE/DENT layouts, and area/power scaled
   linearly from the published 28nm GenASM numbers (64 PEs, 8 KiB DC-SRAM,
   96 KiB TB-SRAM per vault). Reproduces the headline 3.6x area / 2.1x
   power claims (asic_numbers.py:222-252). The optional CACTI integration
   (clone+build an external tool, :17-73) is intentionally not vendored;
   the linear-scaling model is the default there and here.

CLI:
  python -m scrooge_tpu.profiling.model improvements
  python -m scrooge_tpu.profiling.model sweep [--out=asic_sweep.csv]
"""

from __future__ import annotations

import argparse
import csv
import math
import sys
from itertools import product

KIBI = 1024

# Published GenASM per-vault reference points (28nm, 1 GHz), the scaling
# anchors of the model (asic_numbers.py:162-220).
GENASM_PES = 64
GENASM_DC_SRAM = 8 * KIBI
GENASM_TB_SRAM = 96 * KIBI
GENASM_DC_LOGIC_AREA = 0.049  # mm^2
GENASM_TB_LOGIC_AREA = 0.016
GENASM_DC_SRAM_AREA = 0.013
GENASM_TB_SRAM_AREA = 0.256
GENASM_DC_LOGIC_POWER = 0.033  # W
GENASM_TB_LOGIC_POWER = 0.004
GENASM_DC_SRAM_POWER = 0.009
GENASM_TB_SRAM_POWER = 0.055


def single_window_latency(W: int, O: int, pes: int) -> int:
    """Cycles per window: DC = (2W+1) per block of <=PES chars, TB = W-O."""
    dc_cycles_per_block = 2 * W + 1
    blocks = math.ceil(W / pes)
    return dc_cycles_per_block * blocks + (W - O)


def sequence_latency(seq_len: int, W: int, O: int, pes: int) -> int:
    windows = math.ceil(seq_len / (W - O))
    return single_window_latency(W, O, pes) * windows


def vault_throughput(seq_len: int, W: int, O: int, pes: int,
                     frequency: float) -> float:
    return frequency / sequence_latency(seq_len, W, O, pes)


def dc_bytes(W: int) -> float:
    """DC-SRAM scales linearly with W from the 8 KiB @ W=64 anchor."""
    return GENASM_DC_SRAM / 64 * W


def tb_memory(W: int, O: int, sene: bool, dent: bool):
    """(columns, bits_per_column, bandwidth_per_column) of the TB SRAM for
    each storage layout (asic_numbers.py:111-136):
      neither: 3 edge bitvectors of W bits, W x W
      SENE:    1 entry bitvector of W bits, (W+1) x W
      DENT:    3 edge bitvectors of W-O bits, W x (W-O)
      both:    1 entry of min(W-O+1, W) bits, (W+1) x min(W-O+1, W)
    """
    if not sene and not dent:
        bits, per_entry, rows, cols = W, 3, W, W
    elif sene and not dent:
        bits, per_entry, rows, cols = W, 1, W + 1, W
    elif dent and not sene:
        bits, per_entry, rows, cols = W - O, 3, W, W - O
    else:
        bits, per_entry, rows, cols = min(W - O + 1, W), 1, W + 1, \
            min(W - O + 1, W)
    return cols, bits * per_entry * rows, bits * per_entry


def area(W: int, O: int, pes: int, sene: bool, dent: bool):
    """(dc_logic, tb_logic, dc_sram, tb_sram) mm^2 per vault."""
    dc_logic = pes * GENASM_DC_LOGIC_AREA / GENASM_PES
    dc_sram = dc_bytes(W) * GENASM_DC_SRAM_AREA / GENASM_DC_SRAM
    tb_logic = GENASM_TB_LOGIC_AREA + (
        GENASM_DC_LOGIC_AREA / GENASM_PES if sene else 0)
    cols, bits_per_col, _ = tb_memory(W, O, sene, dent)
    tb_bytes = math.ceil(cols * bits_per_col / 8)
    tb_sram = tb_bytes * GENASM_TB_SRAM_AREA / GENASM_TB_SRAM
    return dc_logic, tb_logic, dc_sram, tb_sram


def power(W: int, O: int, pes: int, sene: bool, dent: bool):
    """(dc_logic, tb_logic, dc_sram, tb_sram) W per vault."""
    dc_logic = pes * GENASM_DC_LOGIC_POWER / GENASM_PES
    dc_sram = dc_bytes(W) * GENASM_DC_SRAM_POWER / GENASM_DC_SRAM
    tb_logic = GENASM_TB_LOGIC_POWER + (
        GENASM_DC_LOGIC_POWER / GENASM_PES if sene else 0)
    cols, bits_per_col, _ = tb_memory(W, O, sene, dent)
    tb_bytes = math.ceil(cols * bits_per_col / 8)
    tb_sram = tb_bytes * GENASM_TB_SRAM_POWER / GENASM_TB_SRAM
    return dc_logic, tb_logic, dc_sram, tb_sram


def print_improvements(out=sys.stdout):
    """The Scrooge-vs-GenASM headline table (asic_numbers.py:222-252):
    SENE+DENT at W=64 O=33 vs neither."""
    def dump(tag, vals, unit):
        print(f"{tag}: {sum(vals):.3f}{unit}", file=out)
        for name, v in zip(("DC Logic", "TB Logic", "DC SRAM", "TB SRAM"),
                           vals):
            print(f" - {name}: {v:.3f}{unit}", file=out)

    ga = area(64, 33, 64, False, False)
    sa = area(64, 33, 64, True, True)
    dump("GenASM Area", ga, "mm^2")
    dump("Scrooge Area", sa, "mm^2")
    print(f"Area Improvement: {sum(ga) / sum(sa):.3f}x\n", file=out)

    gp = power(64, 33, 64, False, False)
    sp = power(64, 33, 64, True, True)
    dump("GenASM Power", gp, "W")
    dump("Scrooge Power", sp, "W")
    print(f"Power Improvement: {sum(gp) / sum(sp):.3f}x\n", file=out)


def sweep_rows(seq_len: int = 10_000, frequency: float = 1e9):
    """Config sweep rows (asic_numbers.py:254-295 schema)."""
    rows = []
    for W, O, sene, dent in product([64], range(0, 128), [False, True],
                                    [False, True]):
        if O >= W:
            continue
        a = area(W, O, 64, sene, dent)
        p = power(W, O, 64, sene, dent)
        rate = vault_throughput(seq_len, W, O, 64, frequency)
        rows.append([W, O, sene, dent, sum(a), sum(p), rate])
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("mode", choices=["improvements", "sweep"])
    p.add_argument("--out", default="asic_sweep.csv")
    args = p.parse_args(argv)

    if args.mode == "improvements":
        print_improvements()
    else:
        rows = sweep_rows()
        with open(args.out, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["W", "O", "SENE", "DENT", "area_mm2", "power_W",
                        "aligns_per_second_per_vault"])
            w.writerows(rows)
        print(f"wrote {len(rows)} rows to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
