"""JL sketching of client models (the port of ``repro/core/sketch.py``).

The server clusters a Johnson-Lindenstrauss projection ``S theta`` of
each client's flattened parameters instead of ``theta`` itself.  ``S``
is N(0, 1/s), drawn from an explicit ``torch.Generator`` in blocks of up
to 65 536 rows (as the reference draws one block per ``fold_in``).

The sketch is streamed: blocks run over the concatenated parameter
vector in the reference's flatten order (sorted dict keys), a block may
straddle two leaves, and each step multiplies the (C, block) fp32 slice
of the parameters by the (block, s) slice of S.  At most one block of S
and one (C, block) slice exist at a time, so a model of 494 M
parameters (qwen2-0.5b, whose whole S would take 253 GB at s = 128) is
sketched in a few hundred MB.

Keying: block i is the i-th draw of ONE generator seeded with ``seed``
on the parameters' device (``torch.randn`` of (rows, s), rows =
min(65 536, n - 65 536 i)).  Block 0 of a vector of n <= 65 536 is
therefore the whole projection the port drew before it streamed, and
every block is what ``jl_projection`` stacks.  The port's draws are not
the reference's: tests hand the reference's across as ``projection=``,
the (n, s) matrix, which the sketch slices block by block.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.utils import tree_leaves, tree_leaves_with_path

SKETCH_BLOCK = 1 << 16


def _blocks(n: int, sketch_dim: int, generator: torch.Generator):
    """Yield (start, (rows, s) block of S) over the n rows of S."""
    scale = 1.0 / math.sqrt(sketch_dim)
    for start in range(0, n, SKETCH_BLOCK):
        rows = min(SKETCH_BLOCK, n - start)
        block = torch.randn((rows, sketch_dim), generator=generator,
                            device=generator.device, dtype=torch.float32)
        yield start, block * scale


def make_generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed``."""
    return torch.Generator(device=device).manual_seed(int(seed))


def jl_projection(n: int, sketch_dim: int, *, seed: int,
                  device) -> torch.Tensor:
    """The whole (n, sketch_dim) projection for ``seed``: the blocks
    the streamed sketch draws, stacked (for short client vectors, where
    it is a few KB; the session caches it for n <= 65 536)."""
    gen = make_generator(seed, device)
    return torch.cat([b for _, b in _blocks(n, sketch_dim, gen)], dim=0)


def projection_blocks(n: int, sketch_dim: int, *,
                      seed: Optional[int] = None,
                      projection: Optional[torch.Tensor] = None,
                      device=None):
    """Yield (start, (rows, sketch_dim) fp32 block of S) over n rows: from
    ``projection`` (an (n, s) matrix, sliced) or drawn from ``seed`` on
    ``device``."""
    if projection is None:
        if seed is None:
            raise ValueError("the sketch needs seed= or projection=")
        yield from _blocks(n, sketch_dim, make_generator(seed, device))
        return
    if projection.shape[0] != n:
        raise ValueError(f"clients flatten to {n} values but the "
                         f"projection has {projection.shape[0]} rows")
    for start in range(0, n, SKETCH_BLOCK):
        yield start, projection[start:start + SKETCH_BLOCK].to(
            device, torch.float32)


def _param_slices(leaves, n: int, lead: bool):
    """Yield (start, fp32 slice) over the concatenated vector of
    ``leaves`` in SKETCH_BLOCK steps: (C, rows) when ``lead`` (stacked
    leaves, client axis first), (rows,) otherwise.  A slice that
    straddles leaves is the concatenation of their pieces; each piece is
    cast to fp32 on its own."""
    if lead:
        c = leaves[0].shape[0]
        flat = [l.reshape(c, math.prod(l.shape[1:])) for l in leaves]
    else:
        flat = [l.reshape(-1) for l in leaves]
    bounds, acc = [], 0
    for f in flat:
        bounds.append((acc, acc + f.shape[-1]))
        acc += f.shape[-1]
    for start in range(0, n, SKETCH_BLOCK):
        stop = min(start + SKETCH_BLOCK, n)
        pieces = [f[..., max(start, lo) - lo:min(stop, hi) - lo].to(
                      torch.float32)
                  for f, (lo, hi) in zip(flat, bounds)
                  if lo < stop and hi > start]
        yield start, (pieces[0] if len(pieces) == 1
                      else torch.cat(pieces, dim=-1))


def sketch_leaves(params, leaf_filter=None) -> list:
    """The leaves a sketch projects: all, or those ``leaf_filter(path,
    leaf)`` keeps."""
    if leaf_filter is None:
        return tree_leaves(params)
    return [l for p, l in tree_leaves_with_path(params) if leaf_filter(p, l)]


def _sketch(leaves, sketch_dim: int, lead: bool, *, seed, projection):
    if not leaves:
        raise ValueError("empty parameter tree")
    n = sum((l[0] if lead else l).numel() for l in leaves)
    device = leaves[0].device
    shape = ((leaves[0].shape[0], sketch_dim) if lead else (sketch_dim,))
    acc = torch.zeros(shape, dtype=torch.float32, device=device)
    blocks = projection_blocks(n, sketch_dim, seed=seed,
                               projection=projection, device=device)
    # block by block, in the reference's order of summation
    for (start, block), (_, piece) in zip(blocks,
                                          _param_slices(leaves, n, lead)):
        acc += piece @ block
    return acc


def sketch_vector(vec: torch.Tensor, sketch_dim: int, *,
                  seed: int | None = None,
                  projection: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sketch a flat (n,) vector: ``vec @ S`` with S the given
    ``projection`` or drawn blockwise from ``seed``."""
    return _sketch([vec], sketch_dim, False, seed=seed, projection=projection)


def sketch_rows(flat: torch.Tensor, projection: torch.Tensor) -> torch.Tensor:
    """Sketch a (w, n) stack of flattened clients: (w, sketch_dim)."""
    if flat.shape[1] != projection.shape[0]:
        raise ValueError(f"clients flatten to {flat.shape[1]} values but the "
                         f"projection has {projection.shape[0]} rows")
    return flat.to(torch.float32) @ projection


def sketch_tree(params, sketch_dim: int, *, seed: int | None = None,
                projection: Optional[torch.Tensor] = None,
                leaf_filter=None) -> torch.Tensor:
    """Sketch one client's parameter tree (flattened in sorted-key order),
    streamed.  ``leaf_filter(path, leaf)`` keeps the leaves that take
    part ("/"-joined key path)."""
    return _sketch(sketch_leaves(params, leaf_filter), sketch_dim, False,
                   seed=seed, projection=projection)


def sketch_stacked(params, projection: Optional[torch.Tensor] = None, *,
                   sketch_dim: Optional[int] = None, seed: int | None = None,
                   leaf_filter=None) -> torch.Tensor:
    """Sketch a stacked tree (leading client axis on every leaf), streamed:
    (C, sketch_dim).  S is ``projection`` or drawn from ``seed``
    (``sketch_dim`` then required)."""
    leaves = sketch_leaves(params, leaf_filter)
    if sketch_dim is None:
        if projection is None:
            raise ValueError("sketch_stacked needs sketch_dim= or "
                             "projection=")
        sketch_dim = int(projection.shape[1])
    return _sketch(leaves, sketch_dim, True, seed=seed, projection=projection)
