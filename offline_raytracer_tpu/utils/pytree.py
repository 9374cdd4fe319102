"""Frozen dataclass pytrees.

Every scene, hit and path-state record is one of these: a frozen
dataclass registered with ``jax.tree_util`` so it passes through
``jit``/``grad``/``vmap``/``shard_map`` unchanged, plus a ``.replace``
method for functional updates (``scene.replace(materials=...)``).
"""

from __future__ import annotations

import dataclasses

import jax


def field(*, static: bool = False, **kw):
    """Dataclass field. ``static=True`` keeps the value out of the pytree
    leaves: it lives in the treedef, so it must be hashable and may drive
    Python-level control flow and shapes under ``jit``."""
    return dataclasses.field(metadata={"static": static}, **kw)


def dataclass(cls):
    """Frozen dataclass + pytree registration + ``.replace``."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    cls.replace = lambda self, **kw: dataclasses.replace(self, **kw)
    return jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields if not f.metadata.get("static")],
        meta_fields=[f.name for f in fields if f.metadata.get("static")])
