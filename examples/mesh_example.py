"""Multi-device alignment demo: the pairs-axis mesh.

The reference is single-GPU (GPU_ID 0, genasm_gpu.cu:67); this framework
adds data parallelism over alignment pairs on a `jax.sharding.Mesh`
(scrooge_tpu/parallel/). Two ways to use it:

 1. Automatic: `api.align_*` shards batches over all local devices when
    more than one is visible (api._resolve_mesh) — no code changes.
 2. Explicit: build a mesh and call the engine-level helpers, e.g. to
    control device subsets or compose with other sharded computation.

On a multi-GPU host the demo uses the cards and compiles the kernel for
them. With --cpu it runs anywhere: 8 virtual CPU devices, and the kernel
in the Pallas interpreter.

Run: python examples/mesh_example.py [--cpu]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))
ON_CPU = "--cpu" in sys.argv[1:]
if ON_CPU:  # 8 virtual devices on the host CPU (set before jax loads)
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")
    os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np

import jax
import scrooge_tpu
from scrooge_tpu import AlignConfig


def automatic_mesh():
    """align_all on a multi-device host: sharding is automatic."""
    rng = np.random.default_rng(0)
    n = 256
    texts, queries = [], []
    for _ in range(n):
        t = "".join(rng.choice(list("ACGT"), 160))
        q = "".join(c if rng.random() > 0.05 else "A" for c in t[:120])
        texts.append(t)
        queries.append(q)
    cfg = AlignConfig(backend="xla", batch_tile=256)
    alns = scrooge_tpu.align_all(texts, queries, config=cfg)
    print(f"{len(jax.devices())} devices, {n} pairs -> "
          f"mean edit distance "
          f"{sum(a.edit_distance for a in alns) / n:.1f}")


def explicit_mesh():
    """Engine-level: the Pallas window kernel under shard_map, sharded on
    the pairs axis (compiled on GPUs; interpreted with --cpu,
    bit-identical)."""
    from scrooge_tpu.ops import engine_pallas
    from scrooge_tpu.parallel import make_mesh
    from scrooge_tpu.parallel.mesh import pallas_align_on_mesh

    mesh = make_mesh(len(jax.devices()))
    cfg = AlignConfig(W=64, K=64, O=33,
                      batch_tile=128 * len(jax.devices()),
                      interpret=ON_CPU)
    # small shapes: with --cpu the kernel runs in the (slow) interpreter
    B, read_len, text_len = cfg.batch_tile, 100, 140
    rng = np.random.default_rng(1)
    text = rng.integers(0, 4, (B, text_len), dtype=np.uint8)
    pattern = np.where(rng.random((B, read_len)) < 0.05,
                       rng.integers(0, 4, (B, read_len), dtype=np.uint8),
                       text[:, :read_len]).astype(np.uint8)
    maxw = cfg.max_windows(read_len)
    res = pallas_align_on_mesh(
        cfg, maxw, mesh,
        engine_pallas.pack_2bit_host(text),
        np.full(B, text_len, np.int32),
        engine_pallas.pack_2bit_host(pattern),
        np.full(B, read_len, np.int32))
    eds = np.asarray(res.edit_distance)
    print(f"pallas-on-mesh: {B} pairs on {mesh.devices.size} devices, "
          f"mean edit distance {eds.mean():.1f}, "
          f"failed lanes {int(np.asarray(res.failed).sum())}")


if __name__ == "__main__":
    automatic_mesh()
    explicit_mesh()
