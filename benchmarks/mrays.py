"""Per-scene Mrays/s benchmark (forward and forward+backward).

The scaling/throughput harness SURVEY.md §4(e) calls for. One JSON line
per (scene, mode) on stdout; everything else on stderr. Rays are counted
from the integrator's own alive-mask statistics (render_block_stats) —
path segments plus NEE shadow rays — not assumed from spp.

Usage:
    python benchmarks/mrays.py [--scenes blob,shaped] [--spp 32]
        [--size 256] [--backward]
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def bench_forward(scene, cfg, repeats=3):
    import jax.numpy as jnp
    import numpy as np

    from offline_raytracer_tpu.render import render_block_stats_jit

    n_pixels = cfg.width * cfg.height
    block = min(n_pixels, cfg.ray_batch)
    ids = jnp.arange(block, dtype=jnp.int32)
    spp_chunk = max(1, min(cfg.spp, cfg.ray_batch // block))

    out, alive = render_block_stats_jit(scene, cfg, ids, 0, spp_chunk)
    out.block_until_ready()  # compile

    best = float("inf")
    rays = None
    for _ in range(repeats):
        t0 = time.time()
        done_rays = 0.0
        for start in range(0, n_pixels, block):
            bids = jnp.arange(start, min(start + block, n_pixels), dtype=jnp.int32)
            s = 0
            while s < cfg.spp:
                k = min(spp_chunk, cfg.spp - s)
                out, alive = render_block_stats_jit(scene, cfg, bids, s, k)
                s += k
                n_paths = int(bids.shape[0]) * k
                segs = n_paths + float(np.sum(np.asarray(alive))) * n_paths / max(
                    int(bids.shape[0]) * k, 1)
                done_rays += segs
                if cfg.enable_nee and scene.n_lights > 0:
                    done_rays += segs  # one shadow ray per shading point
        out.block_until_ready()
        dt = time.time() - t0
        if dt < best:
            best = dt
            rays = done_rays
    return rays / best / 1e6, best


def bench_backward(scene, cfg, repeats=3):
    """Forward+backward Mrays/s: grad of L2 loss wrt material params."""
    import jax
    import jax.numpy as jnp

    from offline_raytracer_tpu.diff import apply_material_params, material_params
    from offline_raytracer_tpu.render import render_block

    n_pixels = cfg.width * cfg.height
    block = min(n_pixels, cfg.ray_batch)
    ids = jnp.arange(block, dtype=jnp.int32)
    target = jnp.zeros((block, 3))
    params = material_params(scene)

    @jax.jit
    def step(params):
        sc = apply_material_params(scene, params)
        img = render_block(sc, cfg, ids, 0, cfg.spp)
        loss = jnp.mean((img - target) ** 2)
        return jax.grad(lambda p: jnp.mean(
            (render_block(apply_material_params(scene, p), cfg, ids, 0, cfg.spp)
             - target) ** 2))(params), loss

    g, loss = step(params)
    jax.block_until_ready(g)

    best = float("inf")
    for _ in range(repeats):
        t0 = time.time()
        g, loss = step(params)
        jax.block_until_ready(g)
        best = min(best, time.time() - t0)
    # report a paths-based lower bound (camera rays only): the backward
    # pass's own ray count is not measured here
    n_paths = block * cfg.spp
    return n_paths / best / 1e6, best


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenes", default="analytic,shaped,blob")
    ap.add_argument("--spp", type=int, default=32)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--backward", action="store_true")
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()

    from offline_raytracer_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax

    from offline_raytracer_tpu.config import RenderConfig
    from offline_raytracer_tpu.models import scenes as presets

    for name in args.scenes.split(","):
        t0 = time.time()
        scene = presets.BY_NAME[name](args.size, args.size)
        print(f"{name}: scene built in {time.time()-t0:.1f}s", file=sys.stderr)
        cfg = RenderConfig(
            width=args.size, height=args.size, spp=args.spp,
            max_bounces=8, enable_dof=False, ray_batch=1 << 16)

        mrays, secs = bench_forward(scene, cfg, args.repeats)
        print(json.dumps({
            "metric": f"{name}_{args.size}_{args.spp}spp_forward",
            "value": round(mrays, 3), "unit": "Mrays/s",
            "seconds": round(secs, 3), "device": jax.devices()[0].device_kind}),
            flush=True)

        if args.backward:
            mpaths, secs = bench_backward(scene, cfg, args.repeats)
            print(json.dumps({
                "metric": f"{name}_{args.size}_{args.spp}spp_fwd+bwd",
                "value": round(mpaths, 3), "unit": "Mpaths/s",
                "seconds": round(secs, 3), "device": jax.devices()[0].device_kind}),
                flush=True)


if __name__ == "__main__":
    main()
