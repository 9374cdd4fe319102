"""Ring-sharded geometry vs replicated geometry: one timed step each.

The ring mode (parallel/ring.py) shards the BVH across the mesh and
ppermutes ray blocks around the ring accumulating min-t — the mode for
scenes whose geometry exceeds one device's memory. On a replicated-capable
scene it is expected to LOSE to replication (n_dev traversal rounds +
interconnect hops vs one local traversal); this harness records that
cost so the crossover is a measured fact, not a guess.

Run on the visible GPUs: python benchmarks/ring_vs_replicated.py [W] [spp]
Rehearse on CPU: XLA_FLAGS=--xla_force_host_platform_device_count=8 \
         JAX_PLATFORMS=cpu python benchmarks/ring_vs_replicated.py
"""

import json
import sys
import time


def main():
    from offline_raytracer_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax
    import jax.numpy as jnp

    from offline_raytracer_tpu.config import RenderConfig
    from offline_raytracer_tpu.models.scenes import blob
    from offline_raytracer_tpu.parallel.ring import render_block_ring
    from offline_raytracer_tpu.parallel.shard import make_mesh, render_block_sharded

    n_dev = min(8, len(jax.devices()))
    mesh = make_mesh(jax.devices()[:n_dev])
    W = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    spp = int(sys.argv[2]) if len(sys.argv) > 2 else 4
    scene = blob(W, W)
    cfg = RenderConfig(width=W, height=W, spp=spp, max_bounces=6,
                       enable_dof=False)
    ids = jnp.arange(W * W, dtype=jnp.int32)

    def timed(f):
        out = f()
        out.block_until_ready()
        best = float("inf")
        for _ in range(3):
            t0 = time.time()
            out = f()
            out.block_until_ready()
            best = min(best, time.time() - t0)
        return best

    t_rep = timed(lambda: render_block_sharded(scene, cfg, mesh, ids, 0, spp))
    t_ring = timed(lambda: render_block_ring(scene, cfg, mesh, ids, 0, spp))
    print(json.dumps({
        "metric": f"ring_vs_replicated_blob_{W}_{spp}spp",
        "devices": n_dev,
        "replicated_s": round(t_rep, 3),
        "ring_s": round(t_ring, 3),
        "ring_slowdown": round(t_ring / t_rep, 2),
        "device": jax.devices()[0].device_kind}))


if __name__ == "__main__":
    main()
