"""Sweep driver + plotting smoke tests (tiny workloads, XLA backend)."""

import csv
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, timeout=1200):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"  # the portable CPU backend
    env.setdefault("JAX_COMPILATION_CACHE_DIR",
                   os.path.join(REPO, ".jax_cache"))
    return subprocess.run([sys.executable, "-m"] + args, env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=timeout)


@pytest.fixture(scope="module")
def sweep_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("profile")
    proc = _run(["scrooge_tpu.profiling.sweep", "xla", "simulated:128:300",
                 "--profile_dir", str(out), "--max_experiments", "2",
                 "--batch_tile", "128", "--max_W", "32",
                 "--override_W", "32"])
    assert proc.returncode == 0, proc.stderr[-2000:]
    return out


def test_sweep_writes_reference_schema_csvs(sweep_dir):
    wo = sweep_dir / "simulated_128_300_xla_sweep_WO.csv"
    assert wo.exists()
    with open(wo) as f:
        rows = list(csv.reader(f))
    # no constant columns: the SENE/DENT layout axis is not a device
    # throughput axis (sweep.py module docstring); batch records the
    # operating point of every row
    assert rows[0] == ["W", "O", "early termination", "batch",
                       "aligns/second", "engine",
                       "aligns/second min", "aligns/second max", "device"]
    assert len(rows) > 1
    assert float(rows[1][4]) > 0
    assert rows[1][5] in ("xla", "pallas")
    assert rows[1][8] == "cpu"  # every row names the device it ran on
    # spread columns bracket the median
    assert float(rows[1][6]) <= float(rows[1][4]) <= float(rows[1][7])


@pytest.mark.parametrize("target", ["device", "tbcap"])
def test_kernel_sweeps_need_a_gpu(target, tmp_path):
    """The kernel's sweeps fail without a GPU instead of timing the CPU
    under the device sweep's name, and write no CSV."""
    proc = _run(["scrooge_tpu.profiling.sweep", target, "simulated:128:200",
                 "--profile_dir", str(tmp_path)])
    assert proc.returncode != 0
    assert "needs a GPU" in proc.stderr
    assert not list(tmp_path.iterdir())


def test_accuracy_sweep_and_plots(tmp_path):
    out = tmp_path / "profile"
    proc = _run(["scrooge_tpu.profiling.sweep", "accuracy",
                 "simulated:64:200", "--profile_dir", str(out),
                 "--max_experiments", "1", "--batch_tile", "128",
                 "--cigar", "--max_W", "32"])
    assert proc.returncode == 0, proc.stderr[-2000:]
    acc = out / "simulated_64_200_accuracy_sweep_wo_cigar.csv"
    base = out / "simulated_64_200_baselines_accuracy_cigar.csv"
    assert acc.exists() and base.exists()
    with open(base) as f:
        algs = {row[0] for row in list(csv.reader(f))[1:]}
    # every first-party baseline contributed rows (accuracy_baselines
    # parity, cpu_baseline.cpp:784-875)
    assert {"exact", "affine", "banded", "wfa", "gact"} <= algs

    from scrooge_tpu.profiling import plots

    fig = tmp_path / "acc.png"
    plots.plot_accuracy(str(acc), str(base), str(fig))
    assert fig.exists() and fig.stat().st_size > 0

    # cigar inspection on the same CSV
    from scrooge_tpu.tools import cigar_tools

    path_fig = tmp_path / "paths.png"
    cigar_tools.inspect(str(acc), 4, str(path_fig))
    assert path_fig.exists()


def test_throughput_plot(sweep_dir, tmp_path):
    from scrooge_tpu.profiling import plots

    fig = tmp_path / "tp.png"
    plots.plot_throughput(
        str(sweep_dir / "simulated_128_300_xla_sweep_WO.csv"), str(fig))
    assert fig.exists() and fig.stat().st_size > 0


def test_asic_sweep_csv_and_plot(tmp_path):
    proc = _run(["scrooge_tpu.profiling.model", "sweep", "--out",
                 str(tmp_path / "asic.csv")])
    assert proc.returncode == 0, proc.stderr[-2000:]

    from scrooge_tpu.profiling import plots

    fig = tmp_path / "asic.png"
    plots.plot_asic(str(tmp_path / "asic.csv"), str(fig))
    assert fig.exists()


def test_groundtruth_sweep_with_baselines(tmp_path):
    out = tmp_path / "profile"
    proc = _run(["scrooge_tpu.profiling.sweep", "groundtruth",
                 "simulated:8:200", "--profile_dir", str(out),
                 "--max_experiments", "1", "--batch_tile", "128",
                 "--max_W", "32", "--baseline_pairs", "4"])
    assert proc.returncode == 0, proc.stderr[-2000:]
    dev = out / "simulated_8_200_groundtruth_accuracy.csv"
    base = out / "simulated_8_200_groundtruth_baselines.csv"
    assert dev.exists() and base.exists()
    with open(base) as f:
        rows = list(csv.reader(f))[1:]
    algs = {r[0] for r in rows}
    assert {"exact", "affine", "banded", "wfa", "gact"} <= algs
    # the exact aligner reproduces nearly all ground-truth bases on a
    # clean simulated dataset
    exact_fracs = [float(r[3]) for r in rows if r[0] == "exact"]
    assert sum(exact_fracs) / len(exact_fracs) > 0.85

    from scrooge_tpu.profiling import plots

    fig = tmp_path / "gt.png"
    plots.plot_groundtruth(str(dev), str(fig), str(base))
    assert fig.exists() and fig.stat().st_size > 0
