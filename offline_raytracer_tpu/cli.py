"""Command-line renderer.

The entry point the reference hardcodes into main() (macos_main.mm:289-710:
fixed scene path, fixed 1280x720, fixed 2048 spp) — here every knob is a
flag. Usage:

    python -m offline_raytracer_tpu.cli --scene data/testscene.scn \
        --width 1280 --height 720 --spp 256 --out out/render.hdr
    python -m offline_raytracer_tpu.cli --preset blob --spp 64
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def build_parser():
    p = argparse.ArgumentParser(
        prog="offline_raytracer_tpu",
        description="differentiable Monte-Carlo path tracer")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--scene", help=".scn scene file")
    src.add_argument("--preset", choices=[
        "analytic", "blob", "shaped", "letter", "bunny", "dwarf", "testscene"])
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--spp", type=int, default=64)
    p.add_argument("--max-bounces", type=int, default=12)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--rr", type=float, default=0.8, help="Russian-roulette survival prob")
    p.add_argument("--no-nee", action="store_true", help="BSDF sampling only (reference mode)")
    p.add_argument("--no-dof", action="store_true")
    p.add_argument("--no-bvh", action="store_true")
    p.add_argument("--reference-mode", action="store_true",
                   help="match reference estimator: no NEE, no pixel jitter")
    p.add_argument("--ray-batch", type=int, default=1 << 17)
    p.add_argument("--sharded", action="store_true", help="shard over all devices")
    p.add_argument("--multihost", action="store_true",
                   help="join a multi-process cluster (jax.distributed.initialize)"
                        " before building the mesh; implies --sharded")
    p.add_argument("--coordinator", default=None,
                   help="host:port of process 0 (with --multihost)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--out", default="out/render.hdr")
    p.add_argument("--png", default=None, help="also write a tonemapped png")
    p.add_argument("--exposure", type=float, default=1.0)
    p.add_argument("--progress", action="store_true")
    p.add_argument("--config", default=None,
                   help="YAML file of RenderConfig fields (flags win)")
    p.add_argument("--checkpoint", default=None,
                   help="durable accumulation checkpoint (.npz); resumes if present")
    p.add_argument("--checkpoint-every", type=int, default=16,
                   help="spp between checkpoint writes")
    p.add_argument("--trace-dir", default=None,
                   help="write a jax.profiler (Perfetto/TensorBoard) trace here")
    p.add_argument("--meter", action="store_true",
                   help="emit a rays/s render-meter JSON line (stderr)")
    return p


def load_yaml_config(path: str) -> dict:
    """RenderConfig field dict from a YAML file (unknown keys rejected)."""
    import dataclasses

    import yaml

    from offline_raytracer_tpu.config import RenderConfig

    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    fields = {f.name for f in dataclasses.fields(RenderConfig)}
    unknown = set(raw) - fields
    if unknown:
        raise SystemExit(f"unknown RenderConfig keys in {path}: {sorted(unknown)}")
    return raw


def main(argv=None):
    args = build_parser().parse_args(argv)

    import os

    import numpy as np

    from offline_raytracer_tpu.config import RenderConfig
    from offline_raytracer_tpu.render import render_image
    from offline_raytracer_tpu.utils import hdr
    from offline_raytracer_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    if args.multihost:
        # must run before any other jax call creates the single-host backend
        from offline_raytracer_tpu.parallel.shard import init_multihost
        pid = init_multihost(args.coordinator, args.num_processes, args.process_id)
        print(f"multihost: process {pid}", file=sys.stderr)
        args.sharded = True

    t0 = time.time()
    if args.scene:
        from offline_raytracer_tpu.scene.scn import load_scene
        scene, (w, h) = load_scene(args.scene, args.width, args.height)
    else:
        from offline_raytracer_tpu.models import scenes as presets
        size = 256 if args.preset in ("analytic", "shaped") else 512
        w, h = args.width or size, args.height or size
        scene = presets.BY_NAME[args.preset](width=w, height=h)
    print(f"scene loaded in {time.time()-t0:.1f}s "
          f"({int(scene.triangles.mat.shape[0])} tris, "
          f"{int(scene.spheres.radius.shape[0])} spheres, "
          f"{scene.n_lights} NEE lights)", file=sys.stderr)

    yaml_kw = load_yaml_config(args.config) if args.config else {}
    cfg = RenderConfig(**yaml_kw).replace(
        width=w, height=h, spp=args.spp, seed=args.seed,
        max_bounces=args.max_bounces, russian_roulette=args.rr,
        enable_nee=not (args.no_nee or args.reference_mode),
        enable_mis=not (args.no_nee or args.reference_mode),
        pixel_jitter=not args.reference_mode,
        # match the reference's uncompensated final RR gate so renders are
        # comparable to showcase/*.hdr (config.py reference_rr_quirk)
        reference_rr_quirk=args.reference_mode,
        enable_dof=not args.no_dof,
        use_bvh=not args.no_bvh,
        ray_batch=args.ray_batch,
    )

    from offline_raytracer_tpu.utils.profiling import RenderMeter, device_trace
    meter = RenderMeter() if args.meter else None

    t0 = time.time()
    with device_trace(args.trace_dir):
        if args.sharded:
            from offline_raytracer_tpu.parallel.shard import (
                make_mesh, render_image_sharded)
            img = render_image_sharded(scene, cfg, make_mesh())
        elif args.checkpoint:
            from offline_raytracer_tpu.render import render_image_resumable
            img = render_image_resumable(
                scene, cfg, args.checkpoint,
                checkpoint_every_spp=args.checkpoint_every,
                progress=args.progress, meter=meter)
        else:
            img = render_image(scene, cfg, progress=args.progress, meter=meter)
    dt = time.time() - t0
    if meter is not None:
        meter.emit()
    n_paths = w * h * args.spp
    print(f"rendered {w}x{h} @ {args.spp}spp in {dt:.1f}s "
          f"({n_paths/dt/1e6:.2f} Mpaths/s)", file=sys.stderr)

    # in a multi-host run every process holds the full image after the
    # allgather — only process 0 touches the filesystem
    import jax
    if jax.process_index() == 0:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        hdr.write_hdr(args.out, img)
        print(f"wrote {args.out}", file=sys.stderr)
        if args.png:
            hdr.write_png(args.png, hdr.tonemap(img, exposure=args.exposure))
            print(f"wrote {args.png}", file=sys.stderr)
        print(json.dumps({"seconds": dt, "mpaths_per_s": n_paths / dt / 1e6,
                          "width": w, "height": h, "spp": args.spp}))


if __name__ == "__main__":
    main()
