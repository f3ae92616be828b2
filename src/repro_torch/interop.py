"""Carry the reference's weights and random draws into the port.

The reference (JAX) and the port (PyTorch) draw different numbers from
the same seed, so a parity test hands the reference's values across as
numpy arrays: the stacked client parameters, the (n, sketch_dim) JL
projection, (k, d) init centers, and the (n_tables, d) LSH directions
of the approximate kNN fusion graph.  Both packages then compute the
same round.  Nothing here imports the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.federated import FederatedState
from repro_torch.device import resolve_device
from repro_torch.utils import tree_leaves, tree_map


def tensor_from_numpy(arr, device=None, dtype=None) -> torch.Tensor:
    """One array -> a tensor on ``device`` (a copy, so the source may be
    a read-only view of another framework's buffer)."""
    t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(resolve_device(device), dtype or t.dtype)


def params_from_numpy(params, device=None) -> dict:
    """A stacked parameter tree of numpy arrays -> tensors on ``device``."""
    dev = resolve_device(device)
    return tree_map(lambda a: tensor_from_numpy(a, dev), params)


def state_from_numpy(params, device=None) -> FederatedState:
    """A stacked client-parameter tree -> the port's ``FederatedState``."""
    tensors = params_from_numpy(params, device)
    return FederatedState(params=tensors, opt_state=None,
                          n_clients=int(tree_leaves(tensors)[0].shape[0]))


def projection_from_numpy(projection, device=None) -> torch.Tensor:
    """The reference's (n, sketch_dim) JL projection, already scaled by
    1/sqrt(sketch_dim), as the port's ``projection=`` argument."""
    proj = tensor_from_numpy(projection, device, torch.float32)
    if proj.ndim != 2:
        raise ValueError(f"projection must be (n, sketch_dim), got "
                         f"{tuple(proj.shape)}")
    return proj


def centers_from_numpy(centers, device=None) -> torch.Tensor:
    """(k, d) centers (for ``init="warm"``) as fp32 tensors."""
    c = tensor_from_numpy(centers, device, torch.float32)
    if c.ndim != 2:
        raise ValueError(f"centers must be (k, d), got {tuple(c.shape)}")
    return c


def directions_from_numpy(directions, device=None) -> torch.Tensor:
    """The reference's LSH projection directions (one ``(d,)`` normal
    draw per table, stacked to (n_tables, d)) as the ``directions=``
    option of the ``knn-approx`` edge set."""
    dirs = tensor_from_numpy(directions, device, torch.float32)
    if dirs.ndim != 2:
        raise ValueError(f"directions must be (n_tables, d), got "
                         f"{tuple(dirs.shape)}")
    return dirs
