"""Checkpoint / resume.

The reference has none: the framebuffer lives in RAM until a single final
write (macos_main.mm:683-707) and a crash loses the whole render. Here
progress is durable at two levels:

- **Render accumulation** (`save_accum` / `load_accum`): the running
  radiance sum and the samples-per-pixel already folded in, written
  atomically as .npz after every spp chunk. A restarted render resumes
  accumulation at the recorded sample index — sample keys are
  counter-based (utils/rng.py), so the resumed image is bitwise the image
  an uninterrupted run would have produced.
- **Inverse-rendering state** (`save_opt_state` / `load_opt_state`):
  params + optimizer state, flattened to their pytree leaves and written
  atomically as one .npz per step (diff.py), so a gradient descent run
  survives preemption.
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np


def _meta_of(cfg) -> dict:
    """Estimate-relevant config only: perf/scheduling knobs (ray_batch,
    traversal backend, ...) don't change what the sums mean, so toggling
    them mid-render must NOT discard resume state (ADVICE r1)."""
    import dataclasses

    perf_only = set(getattr(cfg, "PERF_ONLY", ()))
    return {k: v for k, v in dataclasses.asdict(cfg).items()
            if k not in perf_only}


def _meta_compatible(stored: dict, current: dict) -> bool:
    """Versioned-meta comparison: keys present in both must agree; keys
    known to only one side (older/newer writer) are ignored."""
    common = stored.keys() & current.keys()
    return all(stored[k] == current[k] for k in common)


def _atomic_savez(path: str, *args, **arrays) -> None:
    """np.savez to ``path`` via a temp file + rename: never half-written."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, *args, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def save_accum(path: str, accum: np.ndarray, spp_done: int, cfg) -> None:
    """Atomically write the accumulation state for (cfg, spp_done)."""
    _atomic_savez(path, accum=np.asarray(accum, np.float32),
                  spp_done=np.int64(spp_done),
                  meta=np.frombuffer(json.dumps(_meta_of(cfg)).encode(), np.uint8))


def load_accum(path: str, cfg):
    """(accum (P,3), spp_done) if the checkpoint matches cfg, else None.

    A config mismatch (different size / seed / estimator knobs) makes the
    stored sums meaningless, so it is treated as no checkpoint rather
    than silently blending incompatible estimates.
    """
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            meta = json.loads(bytes(z["meta"]).decode())
            if not _meta_compatible(meta, _meta_of(cfg)):
                return None
            return np.asarray(z["accum"], np.float32), int(z["spp_done"])
    except Exception:
        return None


# ------------------------------------------------ inverse-rendering state


def _opt_path(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"step_{step:08d}.npz")


def save_opt_state(directory: str, step: int, params, opt_state) -> None:
    """Save one inverse-rendering step (params + optimizer state)."""
    import jax

    leaves = jax.tree_util.tree_leaves({"params": params, "opt_state": opt_state})
    _atomic_savez(_opt_path(directory, step), *[np.asarray(x) for x in leaves])


def latest_opt_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(n[5:-4]) for n in os.listdir(directory)
             if n.startswith("step_") and n.endswith(".npz") and n[5:-4].isdigit()]
    return max(steps) if steps else None


def load_opt_state(directory: str, step: int, params_like, opt_state_like):
    """Restore (params, opt_state) saved at `step`; the pytree structure
    comes from the *_like arguments and must match what was saved."""
    import jax
    import jax.numpy as jnp

    treedef = jax.tree_util.tree_structure(
        {"params": params_like, "opt_state": opt_state_like})
    with np.load(_opt_path(directory, step)) as z:
        leaves = [jnp.asarray(z[f"arr_{i}"]) for i in range(len(z.files))]
    if len(leaves) != treedef.num_leaves:
        raise ValueError(
            f"checkpoint step {step} holds {len(leaves)} leaves, "
            f"expected {treedef.num_leaves}")
    out = jax.tree_util.tree_unflatten(treedef, leaves)
    return out["params"], out["opt_state"]
