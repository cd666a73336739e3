"""Gradient bucketing: params-shaped tree <-> fixed-size collective buckets.

Counterpart of ``akka_allreduce_tpu/ops/bucketing.py``. A gradient tree
is flattened into one f32 vector and cut into equal buckets of
``bucket_elems`` (the last zero-padded): the ``(num_buckets,
bucket_elems)`` bucket matrix whose rows are the sync's wire chunks
(reference: AllreduceWorker.scala:220-233). The leaf order is the JAX
pytree's (dict keys sorted, lists in order), so for the same parameters
the bucket matrix equals the JAX package's bitwise.

The tree helpers (:func:`tree_leaves`, :func:`tree_unflatten`,
:func:`tree_map`) are the port's whole pytree: nested dicts and lists of
tensors.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch


def num_chunks(size: int, max_chunk_size: int) -> int:
    """Chunks needed to cover ``size`` elements (the JAX package's
    ``config.num_chunks``; reference: AllReduceBuffer.scala:44-46)."""
    return math.ceil(size / max_chunk_size)


def tree_leaves(tree) -> list:
    """The leaves of a params-shaped tree, in a fixed order (dict keys
    sorted, lists in order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves):
    """The inverse of :func:`tree_leaves` against a template tree."""
    return _build(like, iter(leaves))


def _build(node, it):
    # a module-level function, not a closure: a nested function that
    # calls itself is a reference cycle, and its cell would hold ``it``
    # and through it every leaf (a step's whole gradient) until the
    # cyclic garbage collector ran
    if isinstance(node, dict):
        return {k: _build(node[k], it) for k in sorted(node)}
    if isinstance(node, (list, tuple)):
        return [_build(v, it) for v in node]
    return next(it)


def tree_map(fn, tree):
    return tree_unflatten(tree, [fn(x) for x in tree_leaves(tree)])


@dataclasses.dataclass(frozen=True, eq=False)
class BucketSpec:
    """Static geometry for round-tripping a tree through buckets.
    ``treedef`` is the tree's nesting with ``None`` leaves."""

    treedef: Any
    shapes: tuple
    dtypes: tuple
    sizes: tuple
    total_size: int
    bucket_elems: int
    num_buckets: int

    @property
    def padded_size(self) -> int:
        return self.num_buckets * self.bucket_elems

    @property
    def pad(self) -> int:
        return self.padded_size - self.total_size


def tree_bucket_spec(tree: Any, bucket_elems: int) -> BucketSpec:
    """Bucket geometry of a tree of tensors (or of anything with
    ``shape`` and ``dtype``), without touching data."""
    if bucket_elems < 1:
        raise ValueError(f"bucket_elems must be >= 1, got {bucket_elems}")
    leaves = tree_leaves(tree)
    shapes = tuple(tuple(leaf.shape) for leaf in leaves)
    sizes = tuple(math.prod(s) for s in shapes)
    total = sum(sizes)
    return BucketSpec(
        treedef=tree_map(lambda _: None, tree), shapes=shapes,
        dtypes=tuple(leaf.dtype for leaf in leaves), sizes=sizes,
        total_size=total, bucket_elems=bucket_elems,
        num_buckets=max(1, num_chunks(total, bucket_elems)))


def tree_to_vector(tree: Any, dtype=torch.float32) -> torch.Tensor:
    """Flatten a tree into one 1-D vector (cast to ``dtype``)."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.zeros((0,), dtype=dtype)
    return torch.cat([leaf.reshape(-1).to(dtype) for leaf in leaves])


def vector_to_tree(vector: torch.Tensor, spec: BucketSpec) -> Any:
    """Rebuild the tree (its shapes and dtypes) from a flat vector; leaves
    of the vector's dtype are views of it."""
    leaves, offset = [], 0
    for shape, dtype, size in zip(spec.shapes, spec.dtypes, spec.sizes):
        leaves.append(vector[offset:offset + size].view(shape).to(dtype))
        offset += size
    return tree_unflatten(spec.treedef, leaves)


def bucketize(tree: Any, bucket_elems: int, dtype=torch.float32
              ) -> "tuple[torch.Tensor, BucketSpec]":
    """Tree -> ``(num_buckets, bucket_elems)`` zero-padded matrix, each
    leaf copied once into its slice."""
    spec = tree_bucket_spec(tree, bucket_elems)
    leaves = tree_leaves(tree)
    device = leaves[0].device if leaves else None
    flat = torch.zeros((spec.padded_size,), dtype=dtype, device=device)
    offset = 0
    for leaf, size in zip(leaves, spec.sizes):
        flat[offset:offset + size].copy_(leaf.reshape(-1))
        offset += size
    return flat.view(spec.num_buckets, spec.bucket_elems), spec


def debucketize(buckets: torch.Tensor, spec: BucketSpec) -> Any:
    """Inverse of :func:`bucketize`: strip the padding, rebuild the tree."""
    return vector_to_tree(buckets.reshape(spec.padded_size)[:spec.total_size],
                          spec)
