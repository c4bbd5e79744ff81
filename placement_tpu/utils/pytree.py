"""Frozen dataclasses that JAX treats as pytrees.

``@pytree.dataclass`` makes a frozen dataclass whose fields are the pytree's
leaves, in declaration order, and gives it ``.replace(**changes)``. A field
declared with ``static_field()`` is kept out of the leaves: it travels in the
tree structure, so it must be hashable, and ``jit`` specialises on its value.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax


def static_field(**kwargs: Any) -> Any:
    """A dataclass field kept out of the pytree's leaves."""
    return dataclasses.field(metadata={"static": True}, **kwargs)


def _replace(self, **changes: Any) -> Any:
    return dataclasses.replace(self, **changes)


def dataclass(cls: type) -> type:
    """Frozen dataclass registered with ``jax.tree_util``."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields if not f.metadata.get("static")],
        meta_fields=[f.name for f in fields if f.metadata.get("static")])
    cls.replace = _replace
    return cls
