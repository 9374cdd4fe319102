"""Checkpoint/resume + profiling subsystems (utils/checkpoint, utils/profiling).

The reference has neither (SURVEY.md §5): a crash loses the whole render
and observability is two printfs. These tests assert the durable-resume
contract: an interrupted render resumed from its checkpoint is bitwise
the uninterrupted render.
"""

import os

import numpy as np
import pytest

from offline_raytracer_tpu.config import RenderConfig
from offline_raytracer_tpu.render import render_image, render_image_resumable
from offline_raytracer_tpu.utils import checkpoint as ckpt
from offline_raytracer_tpu.utils.profiling import PhaseTimer, RenderMeter


CFG = dict(width=16, height=16, spp=8, max_bounces=3, enable_dof=False,
           use_bvh=False)


def test_accum_roundtrip(tmp_path):
    cfg = RenderConfig(**CFG)
    path = str(tmp_path / "accum.npz")
    acc = np.random.default_rng(0).random((256, 3)).astype(np.float32)
    ckpt.save_accum(path, acc, 5, cfg)
    out = ckpt.load_accum(path, cfg)
    assert out is not None
    got, spp = out
    np.testing.assert_array_equal(got, acc)
    assert spp == 5


def test_accum_config_mismatch_rejected(tmp_path):
    cfg = RenderConfig(**CFG)
    path = str(tmp_path / "accum.npz")
    ckpt.save_accum(path, np.zeros((256, 3), np.float32), 5, cfg)
    assert ckpt.load_accum(path, cfg.replace(seed=99)) is None


def test_accum_perf_knob_change_resumes(tmp_path):
    """Perf-only knobs (ray_batch, ray sorting, stack depth) don't change
    the estimate — toggling them mid-render must keep resume state."""
    cfg = RenderConfig(**CFG)
    path = str(tmp_path / "accum.npz")
    ckpt.save_accum(path, np.zeros((256, 3), np.float32), 5, cfg)
    cfg2 = cfg.replace(ray_batch=1 << 10, sort_rays=False, max_stack_depth=32)
    assert ckpt.load_accum(path, cfg2) is not None


def test_resume_is_bitwise_uninterrupted(analytic_scene, tmp_path):
    cfg = RenderConfig(**CFG)
    path = str(tmp_path / "render.npz")
    path2 = str(tmp_path / "render2.npz")

    # uninterrupted run at the same chunking (checkpointing itself must
    # not perturb the estimate)
    straight = render_image_resumable(analytic_scene, cfg, path2,
                                      checkpoint_every_spp=4)

    # interrupted run: stop after the first 4-spp chunk...
    cfg_half = cfg.replace(spp=4)
    render_image_resumable(analytic_scene, cfg_half, path, checkpoint_every_spp=4)
    # ...surgery: relabel the checkpoint as a paused full-spp run
    state = ckpt.load_accum(path, cfg_half)
    assert state is not None and state[1] == 4
    ckpt.save_accum(path, state[0], 4, cfg)

    resumed = render_image_resumable(analytic_scene, cfg, path,
                                     checkpoint_every_spp=4)
    np.testing.assert_array_equal(resumed, straight)

    # and the plain (differently chunked) renderer agrees to fp tolerance
    plain = render_image(analytic_scene, cfg)
    np.testing.assert_allclose(resumed, plain, rtol=1e-4, atol=1e-6)


def test_phase_timer_and_meter():
    t = PhaseTimer()
    with t.phase("a"):
        pass
    with t.phase("a"):
        pass
    assert "a" in t.as_dict() and t.as_dict()["total"] >= 0

    m = RenderMeter()
    m.add_launch(100, [80.0, 60.0, 0.0], nee_enabled=True, seconds=0.5)
    d = m.as_dict()
    assert d["paths"] == 100
    assert d["segments"] == 240            # 100 camera + 140 bounce segments
    assert d["rays"] > d["segments"]       # NEE shadow rays on top
    assert d["mrays_per_s"] > 0


def test_opt_state_roundtrip(tmp_path):
    import jax
    import jax.numpy as jnp
    import optax

    params = {"w": jnp.arange(4.0)}
    opt = optax.adam(1e-2)
    state = opt.init(params)
    state = opt.update({"w": jnp.ones(4)}, state, params)[1]   # count = 1
    d = str(tmp_path / "opt")
    ckpt.save_opt_state(d, 3, params, state)
    assert ckpt.latest_opt_step(d) == 3
    p2, s2 = ckpt.load_opt_state(d, 3, params, opt.init(params))
    np.testing.assert_array_equal(np.asarray(p2["w"]), np.arange(4.0))
    for a, b in zip(jax.tree_util.tree_leaves(s2), jax.tree_util.tree_leaves(state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
