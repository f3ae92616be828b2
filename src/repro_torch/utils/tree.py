"""Parameter trees (nested dicts / lists / tuples of tensors) <-> flat
vectors, in ``jax.tree_util`` order: dict keys sorted, sequences in
order.  This is the port's counterpart of ``repro/utils/tree.py``; the
order matters because the JL sketch projects the flattened vector."""
from __future__ import annotations

import math

import torch


def tree_leaves(tree) -> list:
    """Leaves in ``jax.tree_util`` order (sorted dict keys, depth first)."""
    if isinstance(tree, dict):
        return [l for key in sorted(tree) for l in tree_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [l for sub in tree for l in tree_leaves(sub)]
    if tree is None:
        return []
    return [tree]


def tree_leaves_with_path(tree, prefix: str = "") -> list:
    """(path, leaf) pairs in :func:`tree_leaves` order; a path joins the
    dict keys (and ``[i]`` for sequence items) with "/", as the
    reference's checkpoint keys and leaf filters do."""
    def join(part):
        return part if not prefix else f"{prefix}/{part}"

    if isinstance(tree, dict):
        return [pl for key in sorted(tree)
                for pl in tree_leaves_with_path(tree[key], join(str(key)))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, sub in enumerate(tree)
                for pl in tree_leaves_with_path(sub, join(f"[{i}]"))]
    if tree is None:
        return []
    return [(prefix, tree)]


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leafwise over trees of one structure, visiting leaves
    in :func:`tree_leaves` order."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, tree[key], *(r[key] for r in rest))
                for key in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, sub, *(r[i] for r in rest))
               for i, sub in enumerate(tree)]
        return type(tree)(out) if isinstance(tree, list) else tuple(out)
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_size(tree) -> int:
    """Total number of scalar elements in a tree."""
    return int(sum(l.numel() for l in tree_leaves(tree)))


def tree_to_vector(tree) -> torch.Tensor:
    """Flatten a tree into one 1-D float32 vector."""
    return torch.cat([l.reshape(-1).to(torch.float32)
                      for l in tree_leaves(tree)])


def tree_to_matrix(tree) -> torch.Tensor:
    """Flatten a STACKED tree (every leaf has leading axis C) into the
    (C, n) float32 matrix whose row i is ``tree_to_vector`` of client i."""
    leaves = tree_leaves(tree)
    c = leaves[0].shape[0]
    return torch.cat([l.reshape(c, -1).to(torch.float32) for l in leaves],
                     dim=1)


def vector_to_tree(vec: torch.Tensor, tree_like):
    """Inverse of :func:`tree_to_vector` given a structural template."""
    leaves = tree_leaves(tree_like)
    sizes = [math.prod(l.shape) for l in leaves]
    if sum(sizes) != vec.numel():
        raise ValueError(f"vector of {vec.numel()} elements does not fill a "
                         f"tree of {sum(sizes)}")
    pieces = iter(torch.split(vec, sizes))
    return tree_map(lambda l: next(pieces).reshape(l.shape).to(l.dtype),
                    tree_like)


def tree_axis_mean(tree, axis: int = 0):
    """Mean over a leading (stacked) axis of every leaf."""
    return tree_map(lambda l: torch.mean(l, dim=axis), tree)


def tree_select(tree, idx):
    """Index every leaf along its leading axis."""
    return tree_map(lambda l: l[idx], tree)


def tree_l2_norm(tree) -> torch.Tensor:
    """The tree's L2 norm as a 0-d fp32 tensor, summed in fp32."""
    return torch.sqrt(sum((torch.sum(torch.square(l.to(torch.float32)))
                           for l in tree_leaves(tree)),
                          torch.zeros((), dtype=torch.float32)))


def tree_cast(tree, dtype):
    """Cast the floating leaves to ``dtype``; other leaves stay as they
    are."""
    return tree_map(lambda l: l.to(dtype) if l.is_floating_point() else l,
                    tree)
