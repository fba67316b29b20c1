# Convenience targets (the reference drives everything through make too,
# /root/reference/Makefile). The Python package needs no build step; the
# native helpers compile on demand (scrooge_tpu/native). Targets:

PY ?= python

.PHONY: test test-fast bench smoke native example sweep accuracy figures clean

test:
	$(PY) -m pytest tests/ -q

test-fast:
	$(PY) -m pytest tests/ -q -x -k "not parallel and not distributed"

# needs an NVIDIA GPU (both fail without one)
bench:
	$(PY) bench.py

smoke:
	$(PY) chip_smoke.py

native:
	$(PY) -c "from scrooge_tpu import native; assert native.get_lib(), 'native build failed'; print('native lib OK')"

example:
	$(PY) examples/library_example.py

sweep:
	$(PY) -m scrooge_tpu.profiling.sweep device simulated:256:2000 --profile_dir=profile

accuracy:
	$(PY) -m scrooge_tpu.profiling.sweep groundtruth simulated:256:4000 --max_experiments=8 --max_W=128 --profile_dir=profile
	$(PY) -m scrooge_tpu.profiling.sweep baselines simulated:256:2000 --profile_dir=profile

# regenerate the figures from the recorded profile/ CSVs
PLOT = $(PY) -m scrooge_tpu.profiling.plots
figures:
	$(PLOT) scaling --csv=profile/scaling_virtual_cpu.csv --out=profile/scaling_virtual_cpu.png
	$(PLOT) accuracy --csv=profile/simulated_256_2000_accuracy_sweep_wo.csv --exact_csv=profile/simulated_256_2000_baselines_accuracy.csv --out=profile/accuracy_scores.png
	$(PLOT) groundtruth --csv=profile/simulated_256_4000_groundtruth_accuracy.csv --baselines_csv=profile/simulated_256_4000_groundtruth_baselines.csv --out=profile/groundtruth_accuracy_W.png
	$(PLOT) groundtruth --csv=profile/simulated_512_10000_groundtruth_accuracy.csv --out=profile/groundtruth_accuracy_W10k.png
	$(PLOT) groundtruth --csv=profile/simulated_128_2000_groundtruth_accuracy_O.csv --x=O --out=profile/groundtruth_accuracy_O.png
	$(PLOT) baselines --csv=profile/simulated_512_2000_baselines_cpu.csv --out=profile/baselines_cpu.png
	$(PLOT) asic --csv=profile/asic_sweep.csv --out=profile/asic_area_power.png

clean:
	rm -rf .jax_cache profile scrooge_tpu/native/*.so
	find . -name __pycache__ -type d -exec rm -rf {} +
