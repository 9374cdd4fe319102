"""Inverse rendering on testscene.scn — the configs[4] capability, CI-sized.

The committed full-scale artifact (goldens/inverse_testscene.json +
before/after PNGs, produced by benchmarks/inverse_testscene.py on the
chip) shows a 10x+ loss reduction recovering perturbed albedos and light
emission. This test runs the same pipeline tiny: at spp 2 the L2 loss is
MC-noise-floor-limited (~2x max reduction at this size, measured), so the
assertions are a 1.7x loss drop PLUS actual parameter recovery — the
emission error must fall from 0.67 to below 0.35 (measured 1.91x / 0.285,
deterministic keys; sized to ~95 s under the oversubscribed test mesh).
"""

import jax.numpy as jnp
import numpy as np

from offline_raytracer_tpu import diff
from offline_raytracer_tpu.config import RenderConfig
from offline_raytracer_tpu.render import render_block, tile_pixel_ids
from offline_raytracer_tpu.scene.scn import load_scene


def test_inverse_testscene_recovers_materials(ref_data_dir):
    W, H = 32, 18
    scene, _ = load_scene(f"{ref_data_dir}/testscene.scn", W, H)
    cfg = RenderConfig(width=W, height=H, spp=2, max_bounces=4,
                       enable_dof=False, ray_batch=W * H * 2)
    ids = jnp.asarray(tile_pixel_ids(W, H))
    target = render_block(scene, cfg.replace(spp=8), ids, 1000, 8)

    true_p = diff.material_params(scene)
    init_p = {"diffuse": 0.3 * true_p["diffuse"] + 0.35,
              "emit": true_p["emit"] * 0.33}
    final_p, losses = diff.optimize(
        scene, cfg, target, ids, init_p, steps=16, lr=0.18)

    assert losses[0] / losses[-1] >= 1.7, (losses[0], losses[-1])
    em = np.asarray(true_p["emit"])
    mask = em.sum(-1) > 0
    e1 = (np.abs(np.asarray(final_p["emit"]) - em)[mask].mean()
          / em[mask].mean())
    assert e1 < 0.35, f"emission not recovered: rel err {e1}"
