"""Render configuration.

One dataclass holding every knob that is a compile-time constant in the
reference (SURVEY.md §5 "Config / flag system"): output size override
(macos_main.mm:319-320), spp (:612), Russian-roulette p (:656), BVH depth
(:474), aperture/focal anchor (ray.cpp:1198-1199), fallback roughness
(ray.cpp:1194), epsilon offsets (ray.cpp:1196).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    # image
    width: int = 1280
    height: int = 720

    # sampling
    spp: int = 2048
    seed: int = 0
    max_bounces: int = 12          # hard cap for the lax.scan bounce loop
    russian_roulette: float = 0.8  # survival probability per bounce (ref :656)
    rr_start_bounce: int = 0       # bounce index at which RR starts

    # camera / depth of field (reference ray.cpp:1194-1199)
    aperture_radius: float = 0.1
    focal_anchor_z: float = 0.2    # focal_length = |cam_p - (0,0,anchor_z)|
    enable_dof: bool = True
    aperture_disk: bool = False    # ref samples the aperture *rim* (ring
    #                                bokeh, ray.cpp:1232-1234); True = disk
    pixel_jitter: bool = True      # ref has no pixel jitter (AA only via DOF)

    # shading
    default_roughness: float = 0.01  # ref hardcodes this (ray.cpp:1194)
    roughness_from_material: bool = False  # use material exponent if True
    enable_nee: bool = True        # ref's NEE is #if 0 dead code; ours works
    enable_mis: bool = True
    # Parity-measurement quirk: the reference never compensates the FINAL
    # Russian-roulette gate of a light-terminated path (its light-hit
    # branch skips the f/p update where the /rr division lives,
    # ray.cpp:1358-1371 vs :1374-1404), so every indirect contribution it
    # records is rr_p x the unbiased value. With this flag we reproduce
    # that energy loss (multiply sampled-continuation emissive hits by
    # rr_p) so renders are comparable to showcase/*.hdr. Default OFF: the
    # framework's own estimator is unbiased.
    reference_rr_quirk: bool = False
    hit_eps: float = 1e-4          # dont_get_too_close_epsilon (ray.cpp:1196)
    t_min: float = 1e-6            # Hit_t_Threshold (ray.cpp:5)

    # acceleration
    use_bvh: bool = True
    bvh_leaf_size: int = 128  # packed-BVH leaf size (fixed, ops/bvh.py)
    max_stack_depth: int = 64
    sort_rays: bool = True    # coherence-sort bounce/shadow rays so ray
    #                           packets stay spatially tight (traverse.py)

    # execution
    ray_batch: int = 1 << 17       # rays per device step (pixels*spp chunked)
    accum_dtype: str = "float32"

    # knobs that change only scheduling/perf, never the estimate — excluded
    # from checkpoint resume-compat comparison (utils/checkpoint._meta_of)
    PERF_ONLY = ("ray_batch", "sort_rays", "max_stack_depth")

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


# Preset matching the reference's showcase render exactly
REFERENCE_SHOWCASE = RenderConfig(
    width=1280, height=720, spp=2048,
    enable_nee=False, enable_mis=False, pixel_jitter=False,
    reference_rr_quirk=True,
)
