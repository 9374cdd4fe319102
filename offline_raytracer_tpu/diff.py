"""Inverse rendering: gradient descent through the path tracer.

The capability the reference's forward-only C++ could never have
(SURVEY.md: "no autodiff — the gap defines where the new framework goes
beyond parity"). Gradients flow through the detached-sampling estimator
(integrator.py): hit search and sampled directions are detached, geometry
/ BSDF / light terms stay attached, so d(image)/d(Kd, Ks, Kt, ior, emit,
sphere centers/radii, vertices, camera) is unbiased for continuous
parameters. Silhouette (visibility) gradients are not modeled — the
documented v1 limitation (SURVEY.md §7 hard part 2).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import optax

from offline_raytracer_tpu.config import RenderConfig
from offline_raytracer_tpu.render import render_block
from offline_raytracer_tpu.scene.types import Scene


def material_params(scene: Scene):
    """Default optimizable parameter set: diffuse albedo + emission."""
    return {"diffuse": scene.materials.diffuse, "emit": scene.materials.emit}


def apply_material_params(scene: Scene, p) -> Scene:
    mats = scene.materials.replace(
        diffuse=jnp.clip(p["diffuse"], 0.0, 1.0),
        emit=jnp.maximum(p["emit"], 0.0))
    return scene.replace(materials=mats)


def make_loss_fn(
    scene: Scene, cfg: RenderConfig, target, pixel_ids,
    setter: Callable = apply_material_params,
):
    """L2 image loss as a function of a parameter pytree."""

    def loss_fn(params, sample_lo=0):
        sc = setter(scene, params)
        img = render_block(sc, cfg, pixel_ids, sample_lo, cfg.spp)
        return jnp.mean((img - target) ** 2)

    return loss_fn


def optimize(
    scene: Scene, cfg: RenderConfig, target, pixel_ids, params,
    setter: Callable = apply_material_params,
    steps: int = 100, lr: float = 5e-2, optimizer=None, verbose: bool = False,
    checkpoint_dir: str | None = None, checkpoint_every: int = 25,
):
    """Adam descent on the image loss. Each step uses a fresh spp window
    (stratified over the sample index) so gradient noise is independent
    across steps. Returns (params, losses).

    With ``checkpoint_dir``, (params, optimizer state) are saved
    every ``checkpoint_every`` steps and the run resumes from the latest
    step on restart (utils/checkpoint.py — the elastic-recovery story the
    single-shot reference never needed, SURVEY.md §5)."""
    loss_fn = make_loss_fn(scene, cfg, target, pixel_ids, setter)
    # zero_nans + norm clip: a single pathological sample window (e.g. a
    # near-grazing refraction path at an extreme parameter point) must
    # not poison the optimizer state — observed once at ~step 150 of a
    # 240-step testscene recovery (r5); standard estimator hygiene for
    # Monte-Carlo gradients
    opt = optimizer or optax.chain(
        optax.zero_nans(), optax.clip_by_global_norm(10.0), optax.adam(lr))
    state = opt.init(params)

    from offline_raytracer_tpu.utils import checkpoint as ckpt

    start = 0
    if checkpoint_dir:
        latest = ckpt.latest_opt_step(checkpoint_dir)
        if latest is not None:
            params, state = ckpt.load_opt_state(
                checkpoint_dir, latest, params, state)
            start = latest
            if verbose:
                print(f"resumed inverse rendering at step {start}")

    @jax.jit
    def step(params, state, k):
        loss, grads = jax.value_and_grad(loss_fn)(params, k * cfg.spp)
        updates, state = opt.update(grads, state, params)
        return optax.apply_updates(params, updates), state, loss

    losses = []
    for k in range(start, steps):
        params, state, loss = step(params, state, k)
        losses.append(float(loss))
        if checkpoint_dir and ((k + 1) % checkpoint_every == 0 or k == steps - 1):
            ckpt.save_opt_state(checkpoint_dir, k + 1, params, state)
        if verbose and (k % 10 == 0 or k == steps - 1):
            print(f"step {k:4d}  loss {losses[-1]:.6f}")
    return params, losses
