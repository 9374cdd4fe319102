"""High-level render API: chunked, jitted, differentiable.

Replaces the reference's tile work queue (macos_main.mm:564-671): the
(pixel x sample) space is statically partitioned into device-sized ray
batches — no queue, no atomics, no spin-wait. Each batch is one jitted
wavefront launch; sample chunks accumulate inside jit via lax.scan.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from offline_raytracer_tpu.config import RenderConfig
from offline_raytracer_tpu.integrator import make_brute_trace_fn, trace_paths
from offline_raytracer_tpu.ops.camera import generate_rays
from offline_raytracer_tpu.scene.types import Scene
from offline_raytracer_tpu.utils import rng


def _trace_builder(scene: Scene, cfg: RenderConfig):
    """(closest_hit_fn, occluded_fn_or_None): BVH when the scene carries
    one, dense sweep otherwise (ops/intersect.py docstring)."""
    if cfg.use_bvh and scene.tri_bvh is not None:
        from offline_raytracer_tpu.ops.traverse import (
            make_bvh_occlusion_fn, make_bvh_trace_fn)
        return make_bvh_trace_fn(scene, cfg), make_bvh_occlusion_fn(scene, cfg)
    return make_brute_trace_fn(scene, cfg), None


def _paths_fn(scene: Scene, cfg: RenderConfig):
    """Path-trace callable (ro, rd, keys, collect_stats) -> radiance[, stats]
    through the XLA wavefront integrator."""
    trace_fn, occl_fn = _trace_builder(scene, cfg)

    def f(ro, rd, keys, collect_stats=False):
        return trace_paths(scene, cfg, trace_fn, ro, rd, keys,
                           collect_stats=collect_stats, occl_fn=occl_fn)
    return f


def render_block(scene: Scene, cfg: RenderConfig, pixel_ids, sample_lo: int, n_samples: int):
    """Render `n_samples` paths for each pixel id. Returns (P, 3) mean radiance.

    Pure function of (scene, pixel_ids) — safe to jit/grad/shard. Samples
    are chunked through a lax.scan so peak memory stays at one ray batch.
    """
    P = pixel_ids.shape[0]
    paths = _paths_fn(scene, cfg)
    root = rng.render_key(cfg.seed)

    def one_sample(accum, sample_idx):
        ps_keys = rng.pixel_sample_keys(
            root, pixel_ids, jnp.full((P,), sample_idx, jnp.int32))
        ro, rd = generate_rays(scene.camera, cfg, pixel_ids, ps_keys)
        radiance = paths(ro, rd, ps_keys)
        return accum + radiance, None

    # Small chunks run unrolled, so the path tracer does not sit inside
    # an outer loop body; large chunks keep the scan so compile size stays
    # bounded.
    if n_samples <= 4:
        accum = jnp.zeros((P, 3))
        for k in range(n_samples):
            accum, _ = one_sample(accum, sample_lo + k)
        return accum / n_samples
    accum, _ = jax.lax.scan(
        one_sample, jnp.zeros((P, 3)), sample_lo + jnp.arange(n_samples))
    return accum / n_samples


@functools.partial(jax.jit, static_argnames=("cfg", "n_samples"))
def render_block_jit(scene, cfg, pixel_ids, sample_lo, n_samples):
    # sample_lo is TRACED (it only offsets the sample-index iota): a render
    # sweeps many sample windows and must not recompile per window
    return render_block(scene, cfg, pixel_ids, sample_lo, n_samples)


def tile_pixel_ids(width: int, height: int, tile: int = 32) -> np.ndarray:
    """All pixel ids, permuted to tile-major order (32x32 tiles).

    Feeding blocks in tile order keeps every block spatially tight —
    camera rays share BVH leaves and bounce rays stay region-local. This is
    the coherence the reference gets from its tile work queue
    (macos_main.mm:602-662), recovered as a one-time host-side permutation
    instead of the per-bounce device argsort of rounds 1-2.
    """
    ids = np.arange(width * height, dtype=np.int32)
    x = ids % width
    y = ids // width
    key = (y // tile).astype(np.int64) * (width // tile + 1) + (x // tile)
    return ids[np.argsort(key, kind="stable")]


def render_image(scene: Scene, cfg: RenderConfig, progress: bool = False,
                 meter=None) -> np.ndarray:
    """Full render -> (H, W, 3) float32, row 0 = top (image convention).

    Host loop over pixel blocks; sample accumulation happens on device.
    ``meter``: optional utils.profiling.RenderMeter fed with per-launch
    alive statistics for rays/s accounting.
    """
    import time as _time

    n_pixels = cfg.width * cfg.height
    block = min(n_pixels, max(1, cfg.ray_batch))
    img = np.zeros((n_pixels, 3), np.float32)
    spp_chunk = max(1, min(cfg.spp, cfg.ray_batch // block))

    # Launches are enqueued without host syncs (device handles collected,
    # converted once at the end): on high-latency dispatch paths a per-
    # launch np.asarray would serialize the whole render on the host
    # round-trip instead of the device compute.
    all_ids = tile_pixel_ids(cfg.width, cfg.height)
    pending = []  # (ids, device_accum)
    for start in range(0, n_pixels, block):
        ids = all_ids[start:min(start + block, n_pixels)]
        acc = None
        done = 0
        while done < cfg.spp:
            k = min(spp_chunk, cfg.spp - done)
            if meter is not None:
                t0 = _time.time()
                out, alive = render_block_stats_jit(
                    scene, cfg, jnp.asarray(ids), done, k)
                out.block_until_ready()
                meter.add_launch(ids.size * k, np.asarray(alive),
                                 cfg.enable_nee and scene.n_lights > 0,
                                 _time.time() - t0)
            else:
                out = render_block_jit(scene, cfg, jnp.asarray(ids), done, k)
            acc = out * k if acc is None else acc + out * k
            done += k
            if progress:
                print(f"pixels [{start}:{start + ids.size}) spp {done}/{cfg.spp}", flush=True)
        pending.append((ids, acc))
    for ids, acc in pending:
        img[ids] = np.asarray(acc) / cfg.spp

    # pixel row 0 is the bottom scanline (ray.cpp:1216); flip to image order
    return img.reshape(cfg.height, cfg.width, 3)[::-1]


def render_image_resumable(
    scene: Scene,
    cfg: RenderConfig,
    checkpoint_path: str,
    checkpoint_every_spp: int = 16,
    progress: bool = False,
    meter=None,
) -> np.ndarray:
    """Full render with durable spp-chunked accumulation (utils/checkpoint).

    Sample accumulation runs in spp-major order (all pixels advance
    together) and the running sum is checkpointed after every
    ``checkpoint_every_spp`` samples; a restart resumes at the recorded
    sample index and — because sample keys are counter-based — produces
    bitwise the uninterrupted image. Returns (H, W, 3), row 0 = top.

    ``meter``: optional utils.profiling.RenderMeter fed with per-launch
    alive statistics for rays/s accounting.
    """
    import time as _time

    from offline_raytracer_tpu.utils import checkpoint as ckpt

    n_pixels = cfg.width * cfg.height
    block = min(n_pixels, max(1, cfg.ray_batch))

    state = ckpt.load_accum(checkpoint_path, cfg)
    if state is not None:
        accum, spp_done = state
        if progress:
            print(f"resumed {checkpoint_path} at spp {spp_done}", flush=True)
    else:
        accum = np.zeros((n_pixels, 3), np.float32)
        spp_done = 0

    while spp_done < cfg.spp:
        k = min(checkpoint_every_spp, cfg.spp - spp_done)
        for start in range(0, n_pixels, block):
            ids = np.arange(start, min(start + block, n_pixels), dtype=np.int32)
            t0 = _time.time()
            if meter is not None:
                out, alive = render_block_stats_jit(
                    scene, cfg, jnp.asarray(ids), spp_done, k)
                out.block_until_ready()
                meter.add_launch(
                    ids.size * k, np.asarray(alive),
                    cfg.enable_nee and scene.n_lights > 0,
                    _time.time() - t0)
            else:
                out = render_block_jit(scene, cfg, jnp.asarray(ids), spp_done, k)
            accum[ids] += np.asarray(out) * k
        spp_done += k
        ckpt.save_accum(checkpoint_path, accum, spp_done, cfg)
        if progress:
            print(f"spp {spp_done}/{cfg.spp} checkpointed", flush=True)

    img = accum / cfg.spp
    return img.reshape(cfg.height, cfg.width, 3)[::-1]


def render_block_stats(scene, cfg, pixel_ids, sample_lo: int, n_samples: int):
    """render_block + per-bounce alive counts (summed over samples)."""
    P = pixel_ids.shape[0]
    paths = _paths_fn(scene, cfg)
    root = rng.render_key(cfg.seed)

    def one_sample(carry, sample_idx):
        accum, alive_acc = carry
        ps_keys = rng.pixel_sample_keys(
            root, pixel_ids, jnp.full((P,), sample_idx, jnp.int32))
        ro, rd = generate_rays(scene.camera, cfg, pixel_ids, ps_keys)
        radiance, alive = paths(ro, rd, ps_keys, collect_stats=True)
        return (accum + radiance, alive_acc + alive), None

    carry = (jnp.zeros((P, 3)), jnp.zeros((cfg.max_bounces,)))
    if n_samples <= 4:   # unrolled: see render_block
        for k in range(n_samples):
            carry, _ = one_sample(carry, sample_lo + k)
        accum, alive_acc = carry
        return accum / n_samples, alive_acc
    (accum, alive_acc), _ = jax.lax.scan(
        one_sample, carry, sample_lo + jnp.arange(n_samples))
    return accum / n_samples, alive_acc


@functools.partial(jax.jit, static_argnames=("cfg", "n_samples"))
def render_block_stats_jit(scene, cfg, pixel_ids, sample_lo, n_samples):
    return render_block_stats(scene, cfg, pixel_ids, sample_lo, n_samples)


def render_image_jnp(scene: Scene, cfg: RenderConfig) -> jnp.ndarray:
    """Single-jit differentiable render for small images (inverse rendering).

    Returns (H, W, 3) with row 0 = top. Everything — ray gen, bounce scan,
    sample accumulation — stays inside one traced computation so jax.grad
    works end to end.
    """
    n_pixels = cfg.width * cfg.height
    pixel_ids = jnp.arange(n_pixels, dtype=jnp.int32)
    out = render_block(scene, cfg, pixel_ids, 0, cfg.spp)
    return out.reshape(cfg.height, cfg.width, 3)[::-1]
