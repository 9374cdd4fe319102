"""Multi-chip scaling: shard_map over a device mesh.

Replaces the reference's thread work queue + atomic tile counter
(ThreadWorkQueue, platform.h:307-339 / macos_main.mm:169-240) with a
static partition of the ray space over a 1-D device mesh:

- forward: pixels are sharded along the `rays` axis; the scene (incl.
  BVH) is replicated; no collectives are needed — per-shard framebuffer
  regions are disjoint, the modern analog of disjoint tile rectangles;
- backward (inverse rendering): scene-parameter gradients are psum'd
  over the device interconnect — the all-reduce the reference never needed because it never
  scaled past one process (SURVEY.md §5 "Distributed communication");
- determinism: per-ray counter-based keys (utils/rng.py) make the image
  bitwise independent of device count — asserted by tests/test_parallel.py.

Multi-process: call init_multihost() before building the mesh; the same
code paths then span every process's devices.
"""

from __future__ import annotations

import functools
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from offline_raytracer_tpu.config import RenderConfig
from offline_raytracer_tpu.render import render_block
from offline_raytracer_tpu.scene.types import Scene

try:  # jax>=0.5 exposes shard_map at top level
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map  # type: ignore


RAY_AXIS = "rays"


def init_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> int:
    """Wire this process into a multi-host JAX runtime.

    Calls ``jax.distributed.initialize()`` — after this, ``jax.devices()``
    spans every host in the slice and the exact same ``make_mesh()`` /
    ``shard_map`` code paths below run across processes. With no
    arguments, coordinator and process identity come from a cluster
    environment JAX recognizes (e.g. SLURM); elsewhere pass all three.
    Returns this process's index.

    The reference has nothing to wire here — nothing in it crosses a
    process boundary (SURVEY.md §5 "Distributed communication backend").
    Idempotent: a second call is a no-op.
    """
    if getattr(init_multihost, "_done", False):
        return jax.process_index()
    kw = {}
    if coordinator_address is not None:
        kw["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kw["num_processes"] = num_processes
    if process_id is not None:
        kw["process_id"] = process_id
    jax.distributed.initialize(**kw)
    init_multihost._done = True
    return jax.process_index()


def make_mesh(devices: Sequence[jax.Device] | None = None) -> Mesh:
    """1-D mesh over all (or the given) devices; axis name `rays`.

    After ``init_multihost()``, ``jax.devices()`` already includes every
    host's chips, so the same call builds a global multi-host mesh."""
    devs = list(devices) if devices is not None else jax.devices()
    return Mesh(np.array(devs), (RAY_AXIS,))


def render_block_sharded(
    scene: Scene, cfg: RenderConfig, mesh: Mesh, pixel_ids,
    sample_lo: int = 0, n_samples: int | None = None,
):
    """Render pixel_ids (P,) sharded over the mesh -> (P, 3) radiance.

    P must be divisible by the mesh size (pad at the caller with -1-free
    ids; pixel ids are arbitrary so duplicates are fine for padding).
    """
    n = n_samples if n_samples is not None else cfg.spp

    def local(scene_rep, ids_shard):
        return render_block(scene_rep, cfg, ids_shard, sample_lo, n)

    fn = shard_map(
        local, mesh=mesh,
        in_specs=(P(), P(RAY_AXIS)),
        out_specs=P(RAY_AXIS),
        check_vma=False,
    )
    return jax.jit(fn)(scene, pixel_ids)


def global_sharded_array(values: np.ndarray, mesh: Mesh, spec: P):
    """Host-local numpy -> a *global* jax.Array sharded over ``mesh``.

    In a multi-process run a plain ``jnp.asarray`` is host-local and
    cannot feed a computation whose sharding spans non-addressable
    devices; ``make_array_from_callback`` hands each process only the
    shards it owns (ADVICE r2: the previous wiring crashed off-host).
    Single-process behavior is identical.
    """
    sharding = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(
        values.shape, sharding, lambda idx: values[idx])


def fetch_global(out) -> np.ndarray:
    """Fetch a possibly multi-host-sharded array to every host as numpy."""
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils
        return np.asarray(multihost_utils.process_allgather(out, tiled=True))
    return np.asarray(out)


def render_image_sharded(scene: Scene, cfg: RenderConfig, mesh: Mesh):
    """Full sharded render -> (H, W, 3) float32 numpy, row 0 = top.

    Multi-host safe: inputs enter as global arrays (each process supplies
    its own shards) and the framebuffer is allgathered across processes.
    """
    n_pixels = cfg.width * cfg.height
    n_dev = mesh.size
    pad = (-n_pixels) % n_dev
    ids_np = (np.arange(n_pixels + pad) % n_pixels).astype(np.int32)
    ids = global_sharded_array(ids_np, mesh, P(RAY_AXIS))
    out = render_block_sharded(scene, cfg, mesh, ids)
    img = fetch_global(out)[:n_pixels]
    return img.reshape(cfg.height, cfg.width, 3)[::-1]


def grad_step_sharded(
    scene: Scene, cfg: RenderConfig, mesh: Mesh, pixel_ids, target,
    param_getter, param_setter,
):
    """One inverse-rendering gradient step, rays sharded over the mesh.

    param_getter(scene) -> pytree of optimizable leaves;
    param_setter(scene, params) -> scene. The L2 image loss is computed
    per shard; leaf gradients are psum'd over the mesh (the backward-path
    collective of SURVEY.md §5). Returns (loss, grads).
    """

    def local(scene_rep, ids_shard, target_shard):
        def loss_fn(params):
            sc = param_setter(scene_rep, params)
            img = render_block(sc, cfg, ids_shard, 0, cfg.spp)
            # mean over the *global* ray set: psum of shard sums
            err = jnp.sum((img - target_shard) ** 2)
            return err

        params = param_getter(scene_rep)
        loss, grads = jax.value_and_grad(loss_fn)(params)
        loss = jax.lax.psum(loss, RAY_AXIS) / (pixel_ids.shape[0] * 3)
        grads = jax.tree.map(
            lambda g: jax.lax.psum(g, RAY_AXIS) / (pixel_ids.shape[0] * 3), grads)
        return loss, grads

    fn = shard_map(
        local, mesh=mesh,
        in_specs=(P(), P(RAY_AXIS), P(RAY_AXIS)),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return jax.jit(fn)(scene, pixel_ids, target)
