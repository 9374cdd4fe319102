"""offline_raytracer_tpu — a differentiable Monte-Carlo path tracer in JAX.

A from-scratch JAX re-design of the capability set of
gyuhyun-lee/offline_raytracer (a CPU/NEON C++ offline ray tracer):

- analytic primitives (sphere / axis-aligned box / cylinder) + triangle meshes
- custom ``.scn`` scene format, PLY and OBJ loaders (reference: parser.cpp)
- full 3-lobe BSDF: Lambert diffuse + GGX microfacet specular + rough dielectric
  transmission with Beer's-law attenuation (reference: ray.cpp:824-1161)
- next-event estimation with MIS (the reference's NEE is disabled dead code;
  here it works), shaped area lights, depth of field, Radiance .hdr output
- BVH acceleration (reference: centroid octree, ray.cpp:1469-2045; here an
  LBVH built host-side into flat SoA arrays, walked by ray packets)

Design for an accelerator, not a port: structure-of-arrays pytrees,
counter-based RNG, a ``lax.scan`` wavefront bounce loop with alive masks
instead of per-ray control flow, and ``shard_map`` over a device mesh
instead of a thread work queue. Everything is plain jnp/lax compiled by
XLA; the package name records where the design started.
"""

__version__ = "0.1.0"

from offline_raytracer_tpu.config import RenderConfig  # noqa: F401
