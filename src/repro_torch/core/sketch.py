"""JL sketching of client models (the port of ``repro/core/sketch.py``).

The server clusters a Johnson-Lindenstrauss projection ``S theta`` of
each client's flattened parameters instead of ``theta`` itself.  ``S``
is N(0, 1/s), drawn from an explicit ``torch.Generator`` in blocks of up
to 65 536 rows (as the reference draws one block per ``fold_in``), so a
long vector is sketched without the whole matrix in memory.  The port's
draws are not the reference's: tests hand the reference's projection in
explicitly (``projection=``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.utils import tree_leaves, tree_to_matrix, tree_to_vector

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
    ``sketch_vector`` draws, stacked (for the short client vectors of the
    ridge/logistic federations, where it is a few KB)."""
    gen = make_generator(seed, device)
    return torch.cat([b for _, b in _blocks(n, sketch_dim, gen)], dim=0)


def sketch_vector(vec: torch.Tensor, sketch_dim: int, *,
                  seed: int | None = None,
                  projection: torch.Tensor | None = None) -> torch.Tensor:
    """Sketch a flat (n,) vector: ``vec @ S`` with S either the given
    (n, sketch_dim) ``projection`` or drawn blockwise from ``seed``."""
    vec = vec.to(torch.float32)
    if projection is not None:
        blocks = ((start, projection[start:start + SKETCH_BLOCK])
                  for start in range(0, vec.shape[0], SKETCH_BLOCK))
    elif seed is not None:
        blocks = _blocks(vec.shape[0], sketch_dim,
                         make_generator(seed, vec.device))
    else:
        raise ValueError("sketch_vector needs seed= or projection=")
    # block by block, in the reference's order of summation
    acc = torch.zeros((sketch_dim,), dtype=torch.float32, device=vec.device)
    for start, block in blocks:
        acc += vec[start:start + block.shape[0]] @ block
    return acc


def sketch_rows(flat: torch.Tensor, projection: torch.Tensor) -> torch.Tensor:
    """Sketch a (w, n) stack of flattened clients: (w, sketch_dim)."""
    if flat.shape[1] != projection.shape[0]:
        raise ValueError(f"clients flatten to {flat.shape[1]} values but the "
                         f"projection has {projection.shape[0]} rows")
    return flat.to(torch.float32) @ projection


def sketch_tree(params, sketch_dim: int, *, seed: int | None = None,
                projection: torch.Tensor | None = None) -> torch.Tensor:
    """Sketch one client's parameter tree (flattened in sorted-key order)."""
    return sketch_vector(tree_to_vector(params), sketch_dim, seed=seed,
                         projection=projection)


def sketch_stacked(params, projection: torch.Tensor) -> torch.Tensor:
    """Sketch a stacked tree (leading client axis on every leaf)."""
    if not tree_leaves(params):
        raise ValueError("empty parameter tree")
    return sketch_rows(tree_to_matrix(params), projection)
