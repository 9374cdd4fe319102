"""Counter-based RNG for reproducible, shardable sampling.

The reference uses a mutable per-tile xorshift32 stream (random.h:5-117)
whose sequence depends on execution order — impossible to shard
deterministically. Here every random draw is keyed by
(base_seed, pixel_id, sample_id, bounce, purpose) through JAX's threefry
counter-based PRNG, so renders are bitwise identical regardless of device
count or tiling (SURVEY.md §5 "multi-host determinism").
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Stream ids ("purpose") for decorrelated draws inside one bounce.
STREAM_APERTURE = 0
STREAM_PIXEL_JITTER = 1
STREAM_LOBE = 2
STREAM_BSDF = 3
STREAM_LIGHT = 4
STREAM_RR = 5


def render_key(seed: int):
    """Root key for a render."""
    return jax.random.PRNGKey(seed)


def pixel_sample_keys(root, pixel_ids, sample_ids):
    """Per-ray keys for (pixel, spp-sample) pairs: (R,) key array.

    Determinism contract: a ray's entire random sequence is a pure function
    of (seed, pixel_id, sample_id) — never of its slot in a batch — so any
    tiling/sharding of the ray set produces the identical image.
    """
    ks = jax.vmap(jax.random.fold_in, (None, 0))(root, pixel_ids)
    return jax.vmap(jax.random.fold_in)(ks, sample_ids)


def stream_keys(ps_keys, bounce, stream):
    """Derive the (bounce, purpose-stream) keys from per-ray keys: (R,)."""
    tag = bounce * 16 + stream
    if jnp.ndim(tag) == 0:
        return jax.vmap(jax.random.fold_in, (0, None))(ps_keys, tag)
    return jax.vmap(jax.random.fold_in)(ps_keys, tag)


def batched_uniform(keys, n: int = 1):
    """(R,) keys -> (R, n) uniforms in [0, 1)."""
    return jax.vmap(lambda k: jax.random.uniform(k, (n,)))(keys)


# ---------------------------------------------------------------------------
# Directly-batched Threefry-2x32: the same permutation as the jax PRNG
# (Salmon et al. 2011) written as plain batched uint32 ops, ~50 integer ops
# per 2 draws, instead of the per-key counter plumbing the vmapped
# jax.random path above lowers to. Determinism contract unchanged: a draw
# is a pure function of (per-ray key, tag, column) — never of batch slot or
# device count.
# ---------------------------------------------------------------------------

_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)


def _rotl(x, r):
    return jax.lax.shift_left(x, jnp.uint32(r)) | jax.lax.shift_right_logical(
        x, jnp.uint32(32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Batched Threefry-2x32: (k0,k1) keys, (x0,x1) counters -> 2 words."""
    ks0, ks1 = k0, k1
    ks2 = ks0 ^ ks1 ^ jnp.uint32(0x1BD11BDA)

    def rounds(x0, x1, rots):
        for r in rots:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        return x0, x1

    x0 = x0 + ks0
    x1 = x1 + ks1
    x0, x1 = rounds(x0, x1, _ROT_A)
    x0, x1 = x0 + ks1, x1 + ks2 + jnp.uint32(1)
    x0, x1 = rounds(x0, x1, _ROT_B)
    x0, x1 = x0 + ks2, x1 + ks0 + jnp.uint32(2)
    x0, x1 = rounds(x0, x1, _ROT_A)
    x0, x1 = x0 + ks0, x1 + ks1 + jnp.uint32(3)
    x0, x1 = rounds(x0, x1, _ROT_B)
    x0, x1 = x0 + ks1, x1 + ks2 + jnp.uint32(4)
    x0, x1 = rounds(x0, x1, _ROT_A)
    return x0 + ks2, x1 + ks0 + jnp.uint32(5)


def _bits_to_unit(x):
    """uint32 -> float32 in [0, 1) using the top 24 bits."""
    return jax.lax.shift_right_logical(x, jnp.uint32(8)).astype(
        jnp.float32) * jnp.float32(1.0 / (1 << 24))


def key_words(ps_keys):
    """Typed key array (R,) -> two (R,) uint32 planes."""
    kd = jax.random.key_data(ps_keys)
    return kd[..., 0], kd[..., 1]


def tagged_uniforms(ps_keys, tag, n: int):
    """(R,) keys + counter tag -> (R, n) uniforms in one batched sweep.

    ``tag`` may be a python int or a traced scalar (the integrator's scan
    passes the bounce index).
    """
    k0, k1 = key_words(ps_keys)
    x0t = jnp.asarray(tag).astype(jnp.uint32) + jnp.zeros_like(k0)
    cols = []
    for j in range(0, n, 2):
        a, b = threefry2x32(k0, k1, x0t, jnp.uint32(j) + jnp.zeros_like(k0))
        cols += [a, b]
    return jnp.stack([_bits_to_unit(c) for c in cols[:n]], -1)


# tag for camera draws, disjoint from bounce indices (tags 0..max_bounces)
CAMERA_TAG = 0x00C0FFEE


def bounce_uniforms(ps_keys, bounce, n: int):
    """All of one bounce's uniforms in one batched threefry sweep: (R, n).

    Column assignment is the caller's stream layout; a value depends only
    on (seed, pixel, sample, bounce, column), never on batch slot.
    """
    return tagged_uniforms(ps_keys, bounce, n)
