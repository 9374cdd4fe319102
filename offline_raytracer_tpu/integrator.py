"""Wavefront path-tracing integrator.

A wavefront redesign of the reference's per-pixel recursive loop
(tiled_raytrace_bvh, ray.cpp:1178-1466): instead of one ray walking a
data-dependent while loop, a whole SoA wavefront of rays advances through a
``lax.scan`` over a fixed bounce budget with an alive mask. Russian
roulette (ref :1280, p=0.8) terminates via the mask with 1/p throughput
compensation; dead lanes ride along masked (the vector analog of the
reference's dormant 4-wide NEON lane model, SURVEY.md §2 component 5).

Differentiability: discrete winners (hit ids) and sampled directions are
detached; hit geometry, BSDF values and light terms stay attached, so
d(image)/d(scene params) flows through the f/p estimator (detached
sampling). Sampling pdfs and MIS weights are detached as well.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from offline_raytracer_tpu.config import RenderConfig
from offline_raytracer_tpu.ops import bsdf as bsdf_ops
from offline_raytracer_tpu.ops import lights as light_ops
from offline_raytracer_tpu.ops.intersect import Hit, closest_hit_bruteforce
from offline_raytracer_tpu.scene.types import Scene
from offline_raytracer_tpu.utils import pytree, rng
from offline_raytracer_tpu.utils.math import normalize

TraceFn = Callable[[jnp.ndarray, jnp.ndarray], Hit]

sg = jax.lax.stop_gradient

# where terminated lanes are parked: far outside any scene AABB (so the
# traversal never descends for them) but small enough that squared terms in
# the analytic intersectors stay finite in f32
PARK_ORIGIN = 1e8


@pytree.dataclass
class PathState:
    origin: jnp.ndarray      # (R, 3)
    direction: jnp.ndarray   # (R, 3)
    throughput: jnp.ndarray  # (R, 3)
    radiance: jnp.ndarray    # (R, 3)
    alive: jnp.ndarray       # (R,) bool
    prev_pdf: jnp.ndarray    # (R,) BSDF pdf of the ray that produced this
    #                          segment; -1 => camera ray (MIS weight 1)
    keys: jnp.ndarray        # (R,) per-path PRNG keys


def make_brute_trace_fn(scene: Scene, cfg: RenderConfig) -> TraceFn:
    def trace(ro, rd):
        return closest_hit_bruteforce(scene, ro, rd, cfg.t_min)
    return trace


def trace_paths(
    scene: Scene,
    cfg: RenderConfig,
    trace_fn: TraceFn,
    origin: jnp.ndarray,
    direction: jnp.ndarray,
    ps_keys: jnp.ndarray,
    collect_stats: bool = False,
    occl_fn=None,
) -> jnp.ndarray:
    """Trace R paths to completion. Returns radiance (R, 3).

    With ``collect_stats=True`` returns ``(radiance, alive_per_bounce)``
    where ``alive_per_bounce`` is (max_bounces,) float32 — the number of
    lanes that produced a continuation segment at each bounce. This is the
    structured replacement for the reference's per-tile ``test_shape_count``
    printf (macos_main.mm:161); see utils/profiling.RenderMeter.
    """
    R = origin.shape[0]
    state = PathState(
        origin=origin,
        direction=direction,
        throughput=jnp.ones((R, 3)),
        radiance=jnp.zeros((R, 3)),
        alive=jnp.ones((R,), bool),
        prev_pdf=jnp.full((R,), -1.0),
        keys=ps_keys,
    )

    mats = scene.materials
    n_lights = scene.n_lights
    do_nee = cfg.enable_nee and n_lights > 0
    do_mis = do_nee and cfg.enable_mis

    def bounce(state: PathState, bounce_idx):
        # all of this bounce's randomness in one threefry sweep:
        # [0] light pick  [1:4] light point  [4] RR  [5:8] bsdf sample
        u8 = rng.bounce_uniforms(state.keys, bounce_idx, 8)
        hit = trace_fn(state.origin, state.direction)
        emit = mats.emit[hit.mat]
        hit_light = mats.is_light[hit.mat] & hit.valid

        # ------ emissive accumulation (implicit light connection, ref :1355-1371)
        if do_mis:
            light_idx = scene.mat_to_light[hit.mat]
            pdf_area = light_ops.light_pdf_area(scene.lights, light_idx)
            cos_l = jnp.sum(hit.normal * (-state.direction), -1)
            p_nee = light_ops.solid_angle_pdf(pdf_area, hit.t, cos_l)
            mis_applies = (light_idx >= 0) & (state.prev_pdf >= 0.0)
            mis_w = jnp.where(
                mis_applies,
                light_ops.mis_balance(state.prev_pdf, p_nee),
                1.0,
            )
        elif do_nee:
            # NEE-only estimator (MIS off): direct light is integrated by
            # the explicit connection, so an emissive found via a sampled
            # continuation (prev_pdf >= 0) must not ALSO add at weight 1 —
            # that double-counts. Camera-primary hits (prev_pdf < 0) keep
            # weight 1. The NEE connection only ever integrates the light's
            # FRONT face (cos_l gate below), so back-facing emissive hits
            # keep weight 1 too — zeroing them would lose energy, not
            # remove a double count (ADVICE r2).
            light_idx = scene.mat_to_light[hit.mat]
            front = jnp.sum(hit.normal * (-state.direction), -1) > 1e-6
            mis_w = jnp.where(
                (light_idx >= 0) & (state.prev_pdf >= 0.0) & front, 0.0, 1.0)
        else:
            mis_w = jnp.ones((R,))
        if cfg.reference_rr_quirk and cfg.russian_roulette < 1.0:
            # reproduce the reference's uncompensated final RR gate on
            # light-terminated paths (config.py reference_rr_quirk) —
            # only for continuations whose producing bounce actually ran
            # an RR gate (ADVICE r4: with rr_start_bounce > 0 the first
            # sampled continuation never passed one)
            quirk_on = bounce_idx > cfg.rr_start_bounce
            mis_w = mis_w * jnp.where(
                (state.prev_pdf >= 0.0) & quirk_on,
                cfg.russian_roulette, 1.0)
        add_emit = state.alive & hit_light
        radiance = state.radiance + jnp.where(
            add_emit[..., None], state.throughput * emit * sg(mis_w)[..., None], 0.0
        )

        alive = state.alive & hit.valid & ~hit_light

        # ------ surface interaction setup
        # backed-off hit point (dont_get_too_close_epsilon, ref :1262, :1411)
        # (miss lanes get a finite dummy t so no inf enters the graph — the
        # double-where discipline that keeps masked gradients NaN-free)
        t_safe = jnp.where(hit.valid, hit.t, 1.0)
        x = state.origin + (t_safe - cfg.hit_eps)[..., None] * state.direction
        x = jnp.where(alive[..., None], x, state.origin)  # keep dead lanes finite
        wo = -state.direction
        n = hit.normal
        safe_mat = jnp.where(alive, hit.mat, 0)
        matp = bsdf_ops.gather_mat_params(
            mats, safe_mat, cfg.default_roughness,
            cfg.roughness_from_material)
        seg_len = jnp.where(hit.valid, hit.t, 0.0)

        # ------ next-event estimation (working version of ref's dead
        # explicit-connection block, ray.cpp:1285-1327)
        if do_nee:
            ls = light_ops.sample_lights(u8[:, 0:4], scene.lights, mats.emit)
            to_l = ls.p - x
            dist_l = jnp.linalg.norm(to_l, axis=-1)
            wi_l = to_l / jnp.maximum(dist_l, 1e-9)[..., None]
            cos_l = jnp.sum(ls.normal * (-wi_l), -1)
            p_nee_solid = light_ops.solid_angle_pdf(ls.pdf_area, dist_l, cos_l)
            # shadow query: any-hit with the light distance as the t bound;
            # dead lanes launch with t_far=0 and cost nothing
            worth = alive & (cos_l > 1e-6)
            if occl_fn is not None:
                x_sh = jnp.where(worth[..., None], x, PARK_ORIGIN)
                tf = jnp.where(worth, dist_l * (1.0 - 1e-3), 0.0)
                visible = ~occl_fn(x_sh, wi_l, tf)
            else:
                sh = trace_fn(x, wi_l)
                visible = sh.t >= dist_l * (1.0 - 1e-3)
            f_l = bsdf_ops.eval_bsdf(n, wi_l, wo, matp, seg_len)
            if do_mis:
                p_b = bsdf_ops.pdf_bsdf(n, wi_l, wo, matp)
                w_l = light_ops.mis_balance(p_nee_solid, p_b)
            else:
                w_l = jnp.ones((R,))
            good = alive & visible & (cos_l > 1e-6) & (p_nee_solid > 1e-9)
            # estimator split: the geometric factor cos/dist^2 AND the
            # area pdf stay ATTACHED — they carry the real derivatives
            # w.r.t. shading geometry (falloff) and light geometry
            # (1/area with the reparameterized sample point); only the
            # MIS weight is detached. Folding these into a detached
            # 1/p_solid silently drops both — caught by the pixel-FD
            # checks in tests/test_grad.py.
            geom = cos_l / jnp.maximum(dist_l * dist_l, 1e-12)
            contrib = (
                state.throughput * f_l * ls.emit
                * (geom * sg(w_l) / jnp.maximum(ls.pdf_area, 1e-12))[..., None]
            )
            radiance = radiance + jnp.where(good[..., None], contrib, 0.0)

        # ------ Russian roulette (ref :1280, gate before each continuation)
        throughput = state.throughput
        if cfg.russian_roulette < 1.0:
            u_rr = u8[:, 4]
            rr_on = bounce_idx >= cfg.rr_start_bounce
            survive = jnp.where(rr_on, u_rr < cfg.russian_roulette, True)
            alive = alive & survive
            throughput = jnp.where(rr_on, throughput / cfg.russian_roulette, throughput)

        # ------ BSDF sampling (implicit continuation, ref :1335) — batched
        samp = bsdf_ops.sample_bsdf(u8[:, 5:8], n, wo, matp)
        wi = sg(normalize(samp.wi))
        pdf = sg(bsdf_ops.pdf_bsdf(n, wi, wo, matp))
        f = bsdf_ops.eval_bsdf(n, wi, wo, matp, seg_len)
        ok_pdf = pdf > 1e-8
        throughput = jnp.where(
            (alive & ok_pdf)[..., None],
            throughput * f / jnp.maximum(pdf, 1e-8)[..., None],
            throughput,
        )
        alive = alive & ok_pdf

        # transmission rays push through the surface instead of backing off
        # (ref :1343-1349)
        x_next = jnp.where(
            samp.is_transmission[..., None],
            state.origin + (t_safe + cfg.hit_eps)[..., None] * state.direction,
            x,
        )

        # park dead lanes far outside the scene: they never pull a BVH
        # descent again (the masked-lane discipline of the reference's
        # dormant NEON model, with the cost actually removed)
        new_state = PathState(
            origin=jnp.where(alive[..., None], x_next, PARK_ORIGIN),
            direction=jnp.where(alive[..., None], wi, state.direction),
            throughput=throughput,
            radiance=radiance,
            alive=alive,
            prev_pdf=jnp.where(alive, pdf, -1.0),
            keys=state.keys,
        )
        return new_state, jnp.sum(alive.astype(jnp.float32))

    state, alive_per_bounce = jax.lax.scan(
        bounce, state, jnp.arange(cfg.max_bounces))
    if collect_stats:
        return state.radiance, alive_per_bounce
    return state.radiance
