"""Inverse rendering on the reference's flagship scene (configs[4]).

BASELINE.json configs[4]: "testscene.scn ... inverse-rendering gradient
descent on BSDF + light params". This script is the committed end-to-end
proof: perturb every material's diffuse albedo and every light's
emission, then recover them from a rendered target of the TRUE scene by
Adam descent through the differentiable forward (plain autodiff through
the wavefront integrator).

Artifacts written (commit them):
  goldens/inverse_testscene.json  — config, loss curve, true/init/final
                                    parameters, recovery errors
  goldens/inverse_testscene_{target,init,final}.png

Run:  RAYTRACER_REF_DATA=<data dir> PYTHONPATH=. \
          python benchmarks/inverse_testscene.py
"""

from __future__ import annotations

import json
import os
import sys
import time

from offline_raytracer_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from offline_raytracer_tpu import diff  # noqa: E402
from offline_raytracer_tpu.config import RenderConfig  # noqa: E402
from offline_raytracer_tpu.models.scenes import testscene  # noqa: E402
from offline_raytracer_tpu.render import render_block, tile_pixel_ids  # noqa: E402
from offline_raytracer_tpu.utils import hdr  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(width=320, height=180, spp=4, target_spp=32, steps=80, lr=4e-2,
        out_dir=None):
    out_dir = out_dir or os.path.join(REPO, "goldens")
    scene = testscene(width, height)
    cfg = RenderConfig(width=width, height=height, spp=spp, max_bounces=6,
                       enable_dof=False, ray_batch=width * height * spp)
    ids = jnp.asarray(tile_pixel_ids(width, height))

    # target: the TRUE scene at higher spp (the "photograph")
    tcfg = cfg.replace(spp=target_spp)
    t0 = time.time()
    target = render_block(scene, tcfg, ids, 1000, target_spp)
    target = jnp.asarray(np.asarray(target))
    print(f"target rendered in {time.time()-t0:.1f}s", file=sys.stderr)

    true_p = diff.material_params(scene)

    # perturb: flatten all albedos toward gray, dim the lights 3x
    init_p = {
        "diffuse": 0.3 * true_p["diffuse"] + 0.35,
        "emit": true_p["emit"] * 0.33,
    }

    def render_with(p, n_spp, lo=2000):
        sc = diff.apply_material_params(scene, p)
        img = np.asarray(render_block(sc, cfg.replace(spp=n_spp),
                                      ids, lo, n_spp))
        full = np.zeros((width * height, 3), np.float32)
        full[np.asarray(ids)] = img
        return full.reshape(height, width, 3)[::-1]

    def save_png(img, name):
        hdr.write_png(os.path.join(out_dir, name), hdr.tonemap(img))

    save_png(render_with(init_p, 16), "inverse_testscene_init.png")
    tgt_full = np.zeros((width * height, 3), np.float32)
    tgt_full[np.asarray(ids)] = np.asarray(target)
    save_png(tgt_full.reshape(height, width, 3)[::-1],
             "inverse_testscene_target.png")

    final_p, losses = diff.optimize(
        scene, cfg, target, ids, init_p, steps=steps, lr=lr, verbose=True)
    save_png(render_with(final_p, 16), "inverse_testscene_final.png")

    def err(p):
        d = float(jnp.abs(jnp.clip(p["diffuse"], 0, 1)
                          - true_p["diffuse"]).mean())
        # emission error over the actual emitters, relative to their scale
        em = np.asarray(true_p["emit"])
        mask = em.sum(-1) > 0
        e = float(np.abs(np.asarray(p["emit"]) - em)[mask].mean()
                  / max(em[mask].mean(), 1e-9))
        return d, e

    d0, e0 = err(init_p)
    d1, e1 = err(final_p)
    rec = {
        "config": {"scene": "testscene.scn", "width": width,
                   "height": height, "spp_step": spp,
                   "spp_target": target_spp, "steps": steps, "lr": lr,
                   "max_bounces": cfg.max_bounces},
        "loss_first": losses[0], "loss_last": losses[-1],
        "loss_reduction_x": losses[0] / max(losses[-1], 1e-12),
        "loss_curve": losses[::2],
        "diffuse_mae_init": d0, "diffuse_mae_final": d1,
        "emit_rel_err_init": e0, "emit_rel_err_final": e1,
        "true_diffuse": np.asarray(true_p["diffuse"]).round(4).tolist(),
        "final_diffuse": np.asarray(
            jnp.clip(final_p["diffuse"], 0, 1)).round(4).tolist(),
        "true_emit": np.asarray(true_p["emit"]).round(3).tolist(),
        "final_emit": np.asarray(final_p["emit"]).round(3).tolist(),
    }
    with open(os.path.join(out_dir, "inverse_testscene.json"), "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps({k: rec[k] for k in
                      ("loss_first", "loss_last", "loss_reduction_x",
                       "diffuse_mae_init", "diffuse_mae_final",
                       "emit_rel_err_init", "emit_rel_err_final")},
                     indent=1))


if __name__ == "__main__":
    run()
