"""Benchmark harness: prints ONE JSON line with the headline metric.

Metric: Mrays/s on the blob scene (models/scenes.blob: a seeded 81,920-face
mesh at the bunny's scale, 512x512, area light + NEE + MIS, 8 bounces),
forward path through the XLA wavefront integrator. "Rays" counts every
traced ray — path extension segments plus NEE shadow rays — from the
integrator's own alive-mask statistics, not assumed from spp. A fwd+bwd
render step (jax.value_and_grad w.r.t. material albedo + mesh vertices)
is timed as well.

Needs a GPU: a measuring path that finds none fails instead of timing the
CPU. Every number is printed beside the device it ran on.
"""

from __future__ import annotations

import json
import sys
import time


def main():
    from offline_raytracer_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax
    import jax.numpy as jnp
    import numpy as np

    from offline_raytracer_tpu.config import RenderConfig
    from offline_raytracer_tpu.models.scenes import blob
    from offline_raytracer_tpu.render import (
        render_block, render_block_jit, render_block_stats_jit, tile_pixel_ids)

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py measures a GPU; JAX found {dev.platform}")
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}

    W = H = 512
    SPP = 32
    t0 = time.time()
    scene = blob(width=W, height=H)
    print(f"scene+BVH built in {time.time()-t0:.1f}s", file=sys.stderr)

    cfg = RenderConfig(width=W, height=H, spp=SPP, max_bounces=8,
                       enable_dof=False, ray_batch=W * H)
    order = tile_pixel_ids(W, H)

    # ---- forward throughput --------------------------------------------
    n_pixels = W * H
    block = min(n_pixels, cfg.ray_batch)
    spp_chunk = 4

    ids0 = jnp.asarray(order[:block])
    t0 = time.time()
    out, alive = render_block_stats_jit(scene, cfg, ids0, 0, spp_chunk)
    np.asarray(out)
    compile_cold_s = time.time() - t0
    print(f"compiled in {compile_cold_s:.1f}s (this process)",
          file=sys.stderr)

    nee = cfg.enable_nee and scene.n_lights > 0
    t0 = time.time()
    launches = []   # (n_paths, device alive handle): read after the loop
    last = None
    for start in range(0, n_pixels, block):
        bids = jnp.asarray(order[start: min(start + block, n_pixels)])
        s = 0
        while s < SPP:
            k = min(spp_chunk, SPP - s)
            out, alive = render_block_stats_jit(scene, cfg, bids, s, k)
            s += k
            launches.append((int(bids.shape[0]) * k, alive))
            last = out
    img = np.asarray(last)
    dt = time.time() - t0
    total_rays = 0.0
    for n_paths, alive in launches:
        # segments: 1 camera ray per path + 1 per surviving bounce;
        # NEE adds 1 shadow ray per shading point (camera + bounces-1)
        a = np.asarray(alive)
        total_rays += n_paths + a.sum()
        if nee:
            total_rays += n_paths + a[:-1].sum()
    assert np.isfinite(img).all() and img.mean() > 0, "bench render broken"
    mrays = total_rays / dt / 1e6
    metric_key = f"blob_{W}x{H}_{SPP}spp"

    # ---- shard_map and ring on all local devices ------------------------
    from offline_raytracer_tpu.parallel.ring import render_block_ring
    from offline_raytracer_tpu.parallel.shard import (
        make_mesh, render_block_sharded)

    mesh = make_mesh()
    probe = jnp.asarray(order[n_pixels // 2: n_pixels // 2 + 4096])
    sh_out = np.asarray(render_block_sharded(scene, cfg, mesh, probe, 0, 2))
    ref_out = np.asarray(render_block_jit(scene, cfg, probe, 0, 2))
    np.testing.assert_allclose(sh_out, ref_out, rtol=1e-5, atol=1e-6)
    ring_out = np.asarray(render_block_ring(
        scene, cfg.replace(max_bounces=4), mesh, probe, 0, 1))
    assert np.isfinite(ring_out).all() and ring_out.mean() >= 0
    print(f"shard_map on Mesh(({mesh.size},)): == unsharded; "
          f"ring step compiled OK", file=sys.stderr)

    # ---- fwd+bwd throughput ---------------------------------------------
    # gradient step w.r.t. material albedo + mesh vertices: plain autodiff
    # through the wavefront integrator (search detached, hits recomputed)
    gcfg = cfg.replace(max_bounces=8)
    gids = jnp.asarray(order[: min(n_pixels, 1 << 16)])

    def loss_fn(diffuse, v0):
        sc = scene.replace(
            materials=scene.materials.replace(diffuse=diffuse),
            triangles=scene.triangles.replace(v0=v0))
        return jnp.mean(render_block(sc, gcfg, gids, 0, 1))

    grad_step = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1)))
    args = (scene.materials.diffuse, scene.triangles.v0)
    t0 = time.time()
    loss, grads = grad_step(*args)
    jax.block_until_ready(grads)
    gcompile_s = time.time() - t0
    # per-step ray count from the same config's alive stats
    _, galive = render_block_stats_jit(scene, gcfg, gids, 0, 1)
    ga = np.asarray(galive)
    g_paths = int(gids.shape[0])
    g_rays = g_paths + ga.sum() + (g_paths + ga[:-1].sum() if nee else 0.0)
    reps = 4
    t0 = time.time()
    for _ in range(reps):
        loss, grads = grad_step(*args)
    jax.block_until_ready(grads)
    g_dt = (time.time() - t0) / reps
    g_mrays = float(g_rays) / g_dt / 1e6
    assert all(np.isfinite(np.asarray(g)).all() for g in grads)
    print(f"fwd+bwd: {g_mrays:.3f} Mrays/s (loss {float(loss):.5f}, "
          f"grad compile {gcompile_s:.1f}s)", file=sys.stderr)

    print(json.dumps({
        "metric": f"{metric_key}_throughput",
        "value": float(mrays),
        "unit": "Mrays/s",
        "fwd_bwd_mrays": float(g_mrays),
        "compile_cold_s": compile_cold_s,
        "device": device,
    }))


if __name__ == "__main__":
    main()
