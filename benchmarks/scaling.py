"""Device-count scaling benchmark: rays/s at 1, 2, 4, ... N devices.

Measures the shard_map data-parallel path (parallel/shard.py): rays/s and
scaling efficiency against one device. Without several devices, rehearse
on the virtual CPU mesh (its times are not device numbers):

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python benchmarks/scaling.py --spp 8 --size 128

On GPUs the same script spans all visible cards (and processes, with
--multihost). One JSON line per device count.
"""

from __future__ import annotations

import argparse
import json
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="blob")
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--multihost", action="store_true",
                    help="join a multi-process cluster before measuring:"
                         " the device counts then span processes")
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    args = ap.parse_args()

    from offline_raytracer_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax

    if args.multihost:
        from offline_raytracer_tpu.parallel.shard import init_multihost
        init_multihost(args.coordinator, args.num_processes, args.process_id)

    import jax.numpy as jnp

    from offline_raytracer_tpu.config import RenderConfig
    from offline_raytracer_tpu.models import scenes as presets
    from offline_raytracer_tpu.parallel.shard import make_mesh, render_block_sharded

    all_devs = jax.devices()
    counts = [n for n in (1, 2, 4, 8, 16, 32) if n <= len(all_devs)]
    scene = presets.BY_NAME[args.scene](args.size, args.size)
    cfg = RenderConfig(width=args.size, height=args.size, spp=args.spp,
                       max_bounces=8, enable_dof=False)

    n_pixels = args.size * args.size
    base_rate = None
    for n in counts:
        mesh = make_mesh(all_devs[:n])
        pad = (-n_pixels) % n
        ids = jnp.arange(n_pixels + pad, dtype=jnp.int32) % n_pixels

        out = render_block_sharded(scene, cfg, mesh, ids)       # compile
        out.block_until_ready()
        best = float("inf")
        for _ in range(args.repeats):
            t0 = time.time()
            out = render_block_sharded(scene, cfg, mesh, ids)
            out.block_until_ready()
            best = min(best, time.time() - t0)
        rate = n_pixels * args.spp / best / 1e6
        if base_rate is None:
            base_rate = rate
        eff = rate / (base_rate * n)
        print(json.dumps({
            "metric": f"{args.scene}_{args.size}_{args.spp}spp_scaling",
            "devices": n,
            "value": round(rate, 3), "unit": "Mpaths/s",
            "seconds": round(best, 3),
            "efficiency_vs_1dev": round(eff, 3),
            "device": all_devs[0].device_kind}), flush=True)


if __name__ == "__main__":
    main()
