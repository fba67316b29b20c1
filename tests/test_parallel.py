"""Multi-device sharding tests.

Each case runs in a subprocess with a genuinely multi-device virtual CPU
platform (8 devices), independent of how the test process itself was
started.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _clean_env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                        "--xla_llvm_disable_expensive_passes=true")
    env["JAX_COMPILATION_CACHE_DIR"] = os.path.join(REPO, ".jax_cache")
    env["JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS"] = "1"
    env["JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES"] = "0"
    return env


def test_dryrun_multichip_8_virtual_devices():
    code = (
        "import __graft_entry__ as g; "
        "g.dryrun_multichip(8, interpret=True); print('OK')"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=_clean_env(),
        capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "OK" in proc.stdout


def test_pallas_on_mesh_production_config():
    """The PERFORMANCE engine (the Pallas kernel, in interpret mode here)
    must run under the pairs mesh at the production config — W=64 K=64
    O=33, multi-window reads — bit-identically to the single-device XLA
    engine, and its compiled sharded program must contain ZERO
    collectives (early termination is per block, shard-local by
    design)."""
    code = """
import numpy as np
import jax
from scrooge_tpu.config import AlignConfig
from scrooge_tpu.ops import engine_pallas, engine_xla
from scrooge_tpu.parallel import mesh as M
import __graft_entry__ as g

cfg = AlignConfig(W=64, K=64, O=33, interpret=True)
B, rl, tl = 1024, 280, 360   # ~13 windows per read
text, tlen, pattern, plen = g._example_batch(B, rl, tl, seed=5)
maxw = cfg.max_windows(rl)
mesh = M.make_mesh(8)
tw = engine_pallas.pack_2bit_host(text)
pw = engine_pallas.pack_2bit_host(pattern)
res = M.pallas_align_on_mesh(cfg, maxw, mesh, tw, tlen, pw, plen)
single = engine_xla.align_batch(cfg, maxw, *map(jax.device_put,
                                                (text, tlen, pattern, plen)))
assert not np.asarray(res.failed).any()
assert np.array_equal(np.asarray(res.edit_distance),
                      np.asarray(single.edit_distance))
# sparse-row compaction on the mesh must equal the single-device compactor
tot = int(np.asarray(res.counts.sum(axis=0)).max())
cap = ((tot + 127) // 128) * 128
cm, tm = M.compact_on_mesh(mesh, res.entries, res.counts, cap, False, True)
c1, t1 = engine_pallas.compact_entries_sparse(
    jax.device_get(res.entries), jax.device_get(res.counts), cap)
assert np.array_equal(np.asarray(cm), np.asarray(c1))
assert np.array_equal(np.asarray(tm), np.asarray(t1))
# zero collectives in the compiled sharded engine
sh2 = M.pair_sharding(mesh, 0, 2); sh1 = M.pair_sharding(mesh, 0, 1)
fn = M._pallas_sharded_fn(cfg, maxw, mesh, False)
hlo = fn.lower(jax.device_put(tw, sh2), jax.device_put(tlen, sh1),
               jax.device_put(pw, sh2), jax.device_put(plen, sh1)
               ).compile().as_text()
bad = [l for l in hlo.splitlines() if any(k in l for k in (
    'all-reduce', 'all-gather', 'all-to-all', 'collective-permute',
    'reduce-scatter'))]
assert not bad, bad[:3]
print('MESHOK')
"""
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=_clean_env(),
        capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "MESHOK" in proc.stdout


def test_api_uses_mesh_automatically():
    """align_pairs must pick up all local devices (8 virtual here) and
    return the same alignments as the scalar oracle."""
    code = """
import random
import jax
import scrooge_tpu
from scrooge_tpu import AlignConfig, pyref
from scrooge_tpu.api import _resolve_mesh

cfg = AlignConfig(batch_tile=1024)
assert _resolve_mesh(cfg) is not None, 'mesh not resolved on 8 devices'
rng = random.Random(17)
texts, queries = [], []
for _ in range(40):
    t = ''.join(rng.choice('ACGT') for _ in range(240))
    q = ''.join(c for c in t if rng.random() > 0.06)
    texts.append(t); queries.append(q)
got = scrooge_tpu.align_all(texts, queries, config=cfg)
for t, q, a in zip(texts, queries, got):
    ed, cigar = pyref.align_pair(t, q, AlignConfig())
    assert a.edit_distance == ed and a.cigar == cigar
print('APIMESH')
"""
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=_clean_env(),
        capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "APIMESH" in proc.stdout


def test_sharded_matches_single_device():
    """Sharded results must equal single-device results bit-for-bit."""
    code = """
import numpy as np
import jax
import __graft_entry__ as g
from scrooge_tpu.config import AlignConfig
from scrooge_tpu.ops.engine_xla import align_batch
from scrooge_tpu.parallel import make_mesh, align_batch_on_mesh

cfg = AlignConfig(W=16, K=16, O=9)
B = 1024
args = g._example_batch(B, 20, 32, seed=3)
maxw = cfg.max_windows(20)
mesh = make_mesh(8)
sharded = align_batch_on_mesh(cfg, maxw, mesh, *args)
single = align_batch(cfg, maxw, *map(jax.device_put, args))
assert np.array_equal(np.asarray(sharded.edit_distance), np.asarray(single.edit_distance))
assert np.array_equal(np.asarray(sharded.entries), np.asarray(single.entries))
assert np.array_equal(np.asarray(sharded.counts), np.asarray(single.counts))
print('MATCH')
"""
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=_clean_env(),
        capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "MATCH" in proc.stdout
