"""Smoke run of the path tracer's main path on one NVIDIA GPU.

    python chip_smoke.py                 # phases 0-4 on one GPU
    python chip_smoke.py --four-cards    # phase 5 only: the sharded paths
                                         # on a 1-D mesh over 4 GPUs
    JAX_PLATFORMS=cpu python chip_smoke.py --write-cpu-reference
                                         # rewrite goldens/chip_smoke_cpu.npz

Phases (one process; any failure exits non-zero before the last line):

0. device: a GPU must be present; prints its kind, jax/jaxlib versions and
   the card's name and power limit (``nvidia-smi``), which tag every
   number printed after it.
1. forward at full size: ``blob(512, 512)`` (81,920 faces, BVH), 8
   bounces, NEE + MIS, no DOF, through ``render_image`` with a
   ``RenderMeter`` (every traced ray counted, shadow rays included); then
   ``cli.main`` in-process on ``--preset blob`` with the same settings,
   whose .hdr must be finite and lit.
2. BVH traversal vs the brute-force reference on the 4,096 tile-ordered
   pixels of the image's central 64x64 window (the mesh) at 2 spp, same
   seeds.
3. card vs CPU: radiance and gradients of ``shaped(64, 64)`` and
   ``blob(64, 64, subdiv=3)`` at 4 spp against goldens/chip_smoke_cpu.npz,
   written on the CPU by ``--write-cpu-reference``. Catches TF32 or any
   other difference in how the GPU lowers the same program.
4. gradient step at full size: ``jax.value_and_grad`` of the mean of
   ``render_block`` w.r.t. (materials.diffuse, triangles.v0) on the 65,536
   pixels of the central 256x256 window x 1 spp of ``blob(512, 512)``, and
   the BVH gradient against the brute-force gradient on the central 4,096
   of those pixels.

The last stdout line is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "goldens", "chip_smoke_cpu.npz")

W = H = 512
SPP = 4                # phase 1; width and face count are never cut
FACES = 81920          # blob(subdiv=6): the bunny's scale
PROBE_HALF = 32        # phases 2 and 4: central 64x64 = 4,096 pixels
GRAD_HALF = 128        # phase 4: central 256x256 = 65,536 pixels
REF_SPP = 4            # phase 3

# Image agreement between two estimates of the same paths (phases 2-3):
# the image means within 2e-3 relative, and fewer than 0.5% of pixels more
# than 1% apart. Same threefry draws on both sides, so a pixel differs only
# where one path took another branch: a winner flip at a triangle edge
# (BVH coefficient test vs Moller-Trumbore) or a last-ulp difference in
# f32 lowering ahead of a comparison. Each flip moves one pixel by a lot,
# so the bound is on the share of such pixels, not on a per-pixel rtol.
MEAN_RTOL = 2e-3
PIXEL_RTOL = 1e-2
PIXEL_SHARE = 5e-3
# Gradient agreement (phases 3-5): each leaf's cosine above 0.999 and its
# norm within 1e-3 relative. A gradient is a sum over every path, so the
# few flipped paths that the pixel bound allows shift it by well under
# 1e-3; TF32 in any contraction would move every term by ~1e-3 and fail it.
# Vertex gradients get 1e-2 on the norm: their norm is held by a few
# vertices hit at grazing angles (in the blob's 64x64 reference, 5 of
# 1,280 rows carry 97.6% of the squared norm), where d(t)/d(vertex) scales
# as 1/(n.d) and amplifies last-ulp differences of the f32 lowering to a
# few 1e-3 (measured on an H100: 2.8e-3, with cosine 0.999997). The
# radiance and material gradients keep 1e-3, so TF32 is still caught.
GRAD_NORM_RTOL = 1e-3
VERTEX_NORM_RTOL = 1e-2
GRAD_COS = 0.999


class Card:
    """Name and power limit of the card(s), to tag every printed number."""

    def __init__(self):
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        self.lines = [s.strip() for s in out.stdout.splitlines() if s.strip()]
        self.tag = self.lines[0]

    def say(self, phase: str, msg: str) -> None:
        print(f"[{phase}] {msg}  ({self.tag})", flush=True)


def check_device(count: int | None = None):
    """The JAX devices, which must be GPUs (and ``count`` of them)."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(
            f"chip_smoke needs an NVIDIA GPU; JAX found {devs[0].platform}")
    if count is not None and len(devs) < count:
        raise RuntimeError(f"need {count} GPUs, JAX found {len(devs)}")
    return devs


def window(half: int) -> np.ndarray:
    """Tile-ordered ids of the pixels within ``half`` of the image center
    ((2 * half)**2 of them): the part of the frame the mesh fills."""
    from offline_raytracer_tpu.render import tile_pixel_ids

    order = tile_pixel_ids(W, H)
    x, y = order % W, order // W
    return order[(np.abs(x + 0.5 - W / 2) < half)
                 & (np.abs(y + 0.5 - H / 2) < half)]


def peak_bytes() -> int:
    import jax

    return int(jax.devices()[0].memory_stats()["peak_bytes_in_use"])


def image_agreement(a, b) -> dict:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-2)
    return {"mean_a": float(a.mean()), "mean_b": float(b.mean()),
            "mean_rel": float(abs(a.mean() - b.mean()) / max(abs(b.mean()), 1e-3)),
            "pixel_share": float((rel.reshape(-1, a.shape[-1]) > PIXEL_RTOL)
                                 .any(-1).mean()),
            "bitwise": bool(np.array_equal(a, b))}


def images_ok(m: dict) -> bool:
    return m["mean_rel"] < MEAN_RTOL and m["pixel_share"] < PIXEL_SHARE


def assert_images_agree(what: str, a, b) -> dict:
    m = image_agreement(a, b)
    if not images_ok(m):
        raise AssertionError(f"{what}: images disagree {m}")
    return m


def grad_agreement(a, b) -> dict:
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    return {"norm_a": float(na), "norm_b": float(nb),
            "norm_rel": float(abs(na - nb) / max(nb, 1e-30)),
            "cos": float(a @ b / max(na * nb, 1e-30)),
            "bitwise": bool(np.array_equal(a, b))}


def grads_ok(m: dict, vertex: bool = False) -> bool:
    rtol = VERTEX_NORM_RTOL if vertex else GRAD_NORM_RTOL
    return m["norm_b"] > 0 and m["norm_rel"] < rtol and m["cos"] > GRAD_COS


def assert_grads_agree(what: str, a, b, vertex: bool = False) -> dict:
    m = grad_agreement(a, b)
    if not grads_ok(m, vertex):
        raise AssertionError(f"{what}: gradients disagree {m}")
    return m


def fmt(m: dict) -> str:
    return " ".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                    for k, v in m.items())


# ---------------------------------------------------------------- phase 3


REF_SCENES = ("shaped", "blob")


def reference_outputs(names=REF_SCENES) -> dict:
    """Radiance and mean-radiance gradients of the small scenes: what
    goldens/chip_smoke_cpu.npz holds, on whatever backend JAX uses."""
    import jax
    import jax.numpy as jnp

    from offline_raytracer_tpu.config import RenderConfig
    from offline_raytracer_tpu.models.scenes import blob, shaped
    from offline_raytracer_tpu.render import render_block

    make = {"shaped": lambda: (shaped(64, 64), ("diffuse",)),
            "blob": lambda: (blob(64, 64, subdiv=3), ("diffuse", "v0"))}
    out = {}
    for name in names:
        scene, fields = make[name]()
        cfg = RenderConfig(width=64, height=64, spp=REF_SPP, max_bounces=8,
                           enable_dof=False)
        ids = jnp.arange(64 * 64, dtype=jnp.int32)

        def loss(params, scene=scene, cfg=cfg, ids=ids):
            sc = scene.replace(materials=scene.materials.replace(
                diffuse=params["diffuse"]))
            if "v0" in params:
                sc = sc.replace(triangles=sc.triangles.replace(v0=params["v0"]))
            img = render_block(sc, cfg, ids, 0, cfg.spp)
            return jnp.mean(img), img

        params = {"diffuse": scene.materials.diffuse}
        if "v0" in fields:
            params["v0"] = scene.triangles.v0
        (_, img), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
        out[f"{name}_radiance"] = np.asarray(img)
        for f in fields:
            out[f"{name}_grad_{f}"] = np.asarray(grads[f])
    return out


def write_cpu_reference() -> None:
    import jax

    if jax.devices()[0].platform != "cpu":
        raise RuntimeError("write the reference with JAX_PLATFORMS=cpu")
    out = reference_outputs()
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    np.savez_compressed(GOLDEN, **out)
    print(f"wrote {GOLDEN}: " + ", ".join(
        f"{k}{tuple(v.shape)}" for k, v in out.items()))


def compare_to_reference(got: dict, ref) -> list[tuple[str, dict, bool]]:
    """(name, metrics, ok) for every array of ``got`` against the committed
    CPU reference."""
    results = []
    for k in sorted(got):
        if k.endswith("_radiance"):
            m = image_agreement(got[k], ref[k])
            ok = images_ok(m)
        else:
            m = grad_agreement(got[k], ref[k])
            ok = grads_ok(m, vertex=k.endswith("_v0"))
        results.append((k, m, ok))
    return results


# ---------------------------------------------------------------- phases


def phase1_forward(card: Card):
    import jax.numpy as jnp

    from offline_raytracer_tpu import cli
    from offline_raytracer_tpu.config import RenderConfig
    from offline_raytracer_tpu.models.scenes import blob
    from offline_raytracer_tpu.render import (
        render_block_stats_jit, render_image, tile_pixel_ids)
    from offline_raytracer_tpu.utils import hdr
    from offline_raytracer_tpu.utils.profiling import RenderMeter

    t0 = time.time()
    scene = blob(W, H)
    n_tris = int(scene.triangles.v0.shape[0])
    card.say("1", f"blob {W}x{H}: {n_tris} faces, scene+BVH built in "
                  f"{time.time() - t0:.3f} s (host)")
    if n_tris != FACES:
        raise AssertionError(f"blob has {n_tris} faces, expected {FACES}")
    cfg = RenderConfig(width=W, height=H, spp=SPP, max_bounces=8,
                       enable_dof=False, ray_batch=W * H)

    # first launch = compile + one run; its steady twin comes from the meter
    ids = jnp.asarray(tile_pixel_ids(W, H))
    t0 = time.time()
    out, _ = render_block_stats_jit(scene, cfg, ids, 0, 1)
    out.block_until_ready()
    first_s = time.time() - t0

    meter = RenderMeter()
    img = render_image(scene, cfg, meter=meter)
    launch_s = meter.seconds / max(meter.launches, 1)
    if not (np.isfinite(img).all() and img.mean() > 0):
        raise AssertionError(f"phase 1 image broken: mean {img.mean()}")
    d = meter.as_dict()
    card.say("1", f"forward {W}x{H}x{SPP}spp 8 bounces NEE+MIS: "
                  f"{d['mrays_per_s']} Mrays/s ({d['rays']} rays in "
                  f"{d['seconds']} s, {meter.launches} launches of "
                  f"{launch_s:.4f} s), compile {first_s - launch_s:.3f} s, "
                  f"peak_bytes_in_use {peak_bytes()}, image mean "
                  f"{float(img.mean()):.6f}")

    hdr_path = os.path.join(ROOT, "out", "chip_smoke_blob.hdr")
    t0 = time.time()
    cli.main(["--preset", "blob", "--width", str(W), "--height", str(H),
              "--spp", str(SPP), "--max-bounces", "8", "--no-dof",
              "--ray-batch", str(W * H), "--meter", "--out", hdr_path])
    cli_s = time.time() - t0
    back = hdr.read_hdr(hdr_path)
    if not (back.shape == (H, W, 3) and np.isfinite(back).all()
            and back.mean() > 0):
        raise AssertionError(f"cli .hdr broken: {back.shape} {back.mean()}")
    card.say("1", f"cli.main --preset blob wrote {hdr_path} in {cli_s:.3f} s: "
                  f"finite, mean {float(back.mean()):.6f}")
    return scene, cfg


def phase2_traversal(card: Card, scene, cfg):
    import jax.numpy as jnp

    from offline_raytracer_tpu.render import render_block_jit

    probe = jnp.asarray(window(PROBE_HALF))
    outs = {}
    for use_bvh in (True, False):
        t0 = time.time()
        outs[use_bvh] = np.asarray(render_block_jit(
            scene, cfg.replace(use_bvh=use_bvh), probe, 0, 2))
        card.say("2", f"use_bvh={use_bvh}: {probe.shape[0]} px x 2 spp in "
                      f"{time.time() - t0:.3f} s (compile included)")
    if not outs[True].mean() > 0:
        raise AssertionError("phase 2 probe window is black")
    m = assert_images_agree("bvh vs brute", outs[True], outs[False])
    card.say("2", f"BVH == brute force within mean_rtol {MEAN_RTOL}, pixel "
                  f"share {PIXEL_SHARE} at {PIXEL_RTOL}: {fmt(m)}")


def phase3_cpu_reference(card: Card):
    t0 = time.time()
    got = reference_outputs()
    with np.load(GOLDEN) as ref:
        if sorted(ref.files) != sorted(got):
            raise AssertionError(f"reference holds {ref.files}, run gave {sorted(got)}")
        results = compare_to_reference(got, ref)
    for k, m, ok in results:
        card.say("3", f"{k} card vs CPU: {'ok' if ok else 'FAIL'} {fmt(m)}")
    bad = [k for k, _, ok in results if not ok]
    if bad:
        raise AssertionError(f"card disagrees with the CPU reference on {bad}")
    card.say("3", f"card == CPU reference ({len(results)} arrays, "
                  f"{time.time() - t0:.3f} s incl. compile)")


def phase4_gradient(card: Card, scene):
    import jax
    import jax.numpy as jnp

    from offline_raytracer_tpu.config import RenderConfig
    from offline_raytracer_tpu.render import render_block, render_block_stats_jit

    gcfg = RenderConfig(width=W, height=H, spp=1, max_bounces=8,
                        enable_dof=False)
    gids = jnp.asarray(window(GRAD_HALF))
    n_px = int(gids.shape[0])

    def step_fn(cfg, ids):
        def loss(diffuse, v0):
            sc = scene.replace(
                materials=scene.materials.replace(diffuse=diffuse),
                triangles=scene.triangles.replace(v0=v0))
            return jnp.mean(render_block(sc, cfg, ids, 0, 1))
        return jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))

    args = (scene.materials.diffuse, scene.triangles.v0)
    step = step_fn(gcfg, gids)
    t0 = time.time()
    loss, grads = step(*args)
    jax.block_until_ready(grads)
    first_s = time.time() - t0
    reps = 3
    t0 = time.time()
    for _ in range(reps):
        loss, grads = step(*args)
    jax.block_until_ready(grads)
    step_s = (time.time() - t0) / reps
    for name, g in zip(("diffuse", "v0"), grads):
        g = np.asarray(g)
        if not (np.isfinite(g).all() and np.abs(g).max() > 0):
            raise AssertionError(f"phase 4 grad {name} not finite/nonzero")
    _, alive = render_block_stats_jit(scene, gcfg, gids, 0, 1)
    a = np.asarray(alive)
    rays = n_px + a.sum() + n_px + a[:-1].sum()
    card.say("4", f"grad step {n_px} px x 1 spp 8 bounces w.r.t. "
                  f"(diffuse, v0): {1.0 / step_s:.4f} steps/s, "
                  f"{rays / step_s / 1e6:.4f} Mrays/s ({int(rays)} rays/step), "
                  f"compile {first_s - step_s:.3f} s, peak_bytes_in_use "
                  f"{peak_bytes()}, loss {float(loss):.6f}")

    pids = jnp.asarray(window(PROBE_HALF))
    g_bvh = step_fn(gcfg, pids)(*args)[1]
    g_bf = step_fn(gcfg.replace(use_bvh=False), pids)(*args)[1]
    for name, a_, b_ in zip(("diffuse", "v0"), g_bvh, g_bf):
        m = assert_grads_agree(f"grad {name} bvh vs brute", a_, b_,
                               vertex=name == "v0")
        card.say("4", f"grad {name} BVH vs brute force on {pids.shape[0]} px: "
                      f"{fmt(m)}")


def phase5_four_cards(card: Card):
    import jax
    import jax.numpy as jnp

    from offline_raytracer_tpu.config import RenderConfig
    from offline_raytracer_tpu.models.scenes import blob
    from offline_raytracer_tpu.parallel.ring import (
        prepare_ring_shards, render_block_ring)
    from offline_raytracer_tpu.parallel.shard import (
        grad_step_sharded, make_mesh, render_block_sharded)
    from offline_raytracer_tpu.render import render_block_jit

    devs = check_device(4)[:4]
    mesh = make_mesh(devs)
    scene = blob(W, H)
    cfg = RenderConfig(width=W, height=H, spp=1, max_bounces=8,
                       enable_dof=False)
    ids = jnp.asarray(window(GRAD_HALF))

    t0 = time.time()
    single = np.asarray(render_block_jit(scene, cfg, ids, 0, 1))
    card.say("5", f"single-card render_block {ids.shape[0]} px: "
                  f"{time.time() - t0:.3f} s (compile included)")
    t0 = time.time()
    sharded = np.asarray(render_block_sharded(scene, cfg, mesh, ids, 0, 1))
    card.say("5", f"render_block_sharded on {mesh.size} cards: "
                  f"{time.time() - t0:.3f} s (compile included)")
    m = assert_images_agree("sharded vs single", sharded, single)
    card.say("5", f"render_block_sharded vs single card: {fmt(m)}")

    target = jnp.zeros((ids.shape[0], 3))

    def getter(sc):
        return {"diffuse": sc.materials.diffuse, "v0": sc.triangles.v0}

    def setter(sc, p):
        return sc.replace(materials=sc.materials.replace(diffuse=p["diffuse"]),
                          triangles=sc.triangles.replace(v0=p["v0"]))

    t0 = time.time()
    _, g_sh = grad_step_sharded(scene, cfg, mesh, ids, target, getter, setter)
    jax.block_until_ready(g_sh)
    card.say("5", f"grad_step_sharded: {time.time() - t0:.3f} s "
                  f"(compile included)")

    def loss_single(p):
        img = render_block_jit(setter(scene, p), cfg, ids, 0, 1)
        return jnp.sum((img - target) ** 2) / (ids.shape[0] * 3)

    g_1 = jax.jit(jax.grad(loss_single))(getter(scene))
    for k in ("diffuse", "v0"):
        m = assert_grads_agree(f"sharded grad {k}", g_sh[k], g_1[k],
                               vertex=k == "v0")
        card.say("5", f"grad_step_sharded {k} vs single card: {fmt(m)}")

    shards = prepare_ring_shards(scene, mesh.size)
    t0 = time.time()
    ring = np.asarray(render_block_ring(scene, cfg, mesh, ids, 0, 1,
                                        shards=shards))
    card.say("5", f"render_block_ring: {time.time() - t0:.3f} s "
                  f"(compile included)")
    m = assert_images_agree("ring vs replicated", ring, single)
    card.say("5", f"render_block_ring vs replicated: {fmt(m)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded paths on a 4-GPU mesh")
    ap.add_argument("--write-cpu-reference", action="store_true",
                    help="rewrite goldens/chip_smoke_cpu.npz (CPU only)")
    args = ap.parse_args(argv)

    if args.write_cpu_reference:
        write_cpu_reference()
        return 0

    import jax
    import jaxlib

    from offline_raytracer_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    devs = check_device(4 if args.four_cards else None)
    card = Card()
    for line in card.lines:
        print(line, flush=True)
    card.say("0", f"{devs[0].platform} {devs[0].device_kind} x{len(devs)}, "
                  f"jax {jax.__version__}, jaxlib {jaxlib.__version__}, "
                  f"compile cache {cache}")

    t_all = time.time()
    if args.four_cards:
        phase5_four_cards(card)
    else:
        scene, cfg = phase1_forward(card)
        phase2_traversal(card, scene, cfg)
        phase3_cpu_reference(card)
        phase4_gradient(card, scene)
    card.say("end", f"all phases passed in {time.time() - t_all:.3f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
