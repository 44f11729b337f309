"""Frozen dataclasses that are JAX pytrees.

``dataclass`` registers a frozen dataclass with ``jax.tree_util``: fields
made with ``field(pytree_node=False)`` are static metadata (part of the
treedef, hashed by ``jit``), every other field is a leaf.  Instances get a
``replace(**changes)`` method.
"""

from __future__ import annotations

import dataclasses

import jax


def field(pytree_node: bool = True, **kwargs):
    """A dataclass field; ``pytree_node=False`` makes it static metadata."""
    metadata = dict(kwargs.pop("metadata", None) or {}, pytree_node=pytree_node)
    return dataclasses.field(metadata=metadata, **kwargs)


def _replace(self, **changes):
    return dataclasses.replace(self, **changes)


def dataclass(cls):
    """Frozen dataclass registered as a pytree (see module docstring)."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    data = [f.name for f in fields if f.metadata.get("pytree_node", True)]
    meta = [f.name for f in fields if not f.metadata.get("pytree_node", True)]
    cls.replace = _replace
    return jax.tree_util.register_dataclass(cls, data_fields=data, meta_fields=meta)
