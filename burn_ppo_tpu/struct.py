"""Frozen dataclasses that are JAX pytrees.

Every device state in this package (env states, normalizers, rollout
carries, the train state) is a frozen dataclass registered with
`jax.tree_util.register_dataclass`. Leaves flatten in field-declaration
order with attribute key paths, which is the order checkpoints store
them in (``checkpoint.save_pytree``), so changing a class's field order
changes its checkpoint layout.

    class State(struct.PyTreeNode):
        x: jax.Array
        size: int = struct.field(pytree_node=False, default=4)

    s = State(x=jnp.zeros(3)).replace(x=jnp.ones(3))

Fields marked ``pytree_node=False`` are static: they are part of the
tree structure (hashed into jit cache keys), never leaves.
"""

from __future__ import annotations

import dataclasses
from typing import Any, TypeVar

import jax

T = TypeVar("T")


def field(pytree_node: bool = True, **kwargs) -> Any:
    """`dataclasses.field` with a ``pytree_node`` flag (False = static)."""
    metadata = dict(kwargs.pop("metadata", None) or {})
    metadata["pytree_node"] = pytree_node
    return dataclasses.field(metadata=metadata, **kwargs)


def dataclass(cls: type[T]) -> type[T]:
    """Make ``cls`` a frozen dataclass registered as a pytree, with a
    ``replace(**changes)`` method."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    data = [f.name for f in fields if f.metadata.get("pytree_node", True)]
    meta = [f.name for f in fields if not f.metadata.get("pytree_node", True)]
    jax.tree_util.register_dataclass(cls, data_fields=data, meta_fields=meta)
    cls.replace = dataclasses.replace
    return cls


class PyTreeNode:
    """Base class: every subclass becomes a `dataclass` above."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        dataclass(cls)
