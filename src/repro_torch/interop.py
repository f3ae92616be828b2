"""Carry the reference's weights and random draws into the port.

The reference (JAX) and the port (PyTorch) draw different numbers from
the same seed, so a parity test hands the reference's values across as
numpy arrays: the stacked client parameters, the (n, sketch_dim) JL
projection (or its blocks), (k, d) init centers (and IFCA's initial
models, and the noise of its ``perturb`` init), the rows of
the ``random`` init and of every minibatch Lloyd iteration, the
(n_tables, d) LSH directions of the approximate kNN fusion graph, a
scenario's draws (its Bernoulli masks and Gaussian blocks), and a
model's parameter tree (any family) and a federation of them with its
AdamW state, and a one-layer KV cache.  ``module_state_dict`` maps the
reference's (and the port's checkpoint) keys onto the port's
``Transformer`` modules.  Both packages then compute the same thing.
Nothing here imports the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.federated import FederatedState
from repro_torch.device import resolve_device
from repro_torch.models.transformer import Transformer, leaf_dtype, n_stack
from repro_torch.utils import tree_leaves, tree_leaves_with_path, tree_map


def tensor_from_numpy(arr, device=None, dtype=None) -> torch.Tensor:
    """One array -> a tensor on ``device`` (a copy, so the source may be
    a read-only view of another framework's buffer).  A bfloat16 array
    (``ml_dtypes.bfloat16``, which ``torch.from_numpy`` does not take)
    goes through float32, which holds every bfloat16 value exactly, and
    comes back as bfloat16 unless ``dtype`` says otherwise."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.astype(np.float32))
        return t.to(resolve_device(device), dtype or torch.bfloat16)
    t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(resolve_device(device), dtype or t.dtype)


def params_from_numpy(params, device=None) -> dict:
    """A stacked parameter tree of numpy arrays -> tensors on ``device``."""
    dev = resolve_device(device)
    return tree_map(lambda a: tensor_from_numpy(a, dev), params)


def state_from_numpy(params, device=None) -> FederatedState:
    """A stacked client-parameter tree -> the port's ``FederatedState``."""
    return federation_from_numpy(params, device=device)


def federation_from_numpy(params, opt_state=None, step: int = 0,
                          device=None) -> FederatedState:
    """A stacked federation (the reference's ``FederatedState``: params
    and, if given, the vmapped AdamW state ``{"mu", "nu", "step"}``)
    -> the port's, on ``device``."""
    tensors = params_from_numpy(params, device)
    opt = None
    if opt_state is not None:
        opt = params_from_numpy(opt_state, device)
        opt["step"] = opt["step"].to(torch.int32)
    return FederatedState(params=tensors, opt_state=opt,
                          n_clients=int(tree_leaves(tensors)[0].shape[0]),
                          step=int(step))


def perturb_noise_from_numpy(noise, device=None):
    """The reference IFCA's ``init="perturb"`` draws (a tree of (k, ...)
    standard normals, one ``normal(split(key, n_leaves)[i])`` a leaf,
    before ``init_scale``) as ``IFCAFederated(perturb_noise=...)``."""
    return params_from_numpy(noise, device)


def module_state_dict(params) -> dict:
    """A single-model parameter tree (the reference's keys, every layer
    weight stacked on L) -> the port ``Transformer``'s state dict:
    ``layers/attn/wq`` row i becomes ``layers.i.attn.wq``."""
    out = {}
    for path, leaf in tree_leaves_with_path(params):
        parts = path.split("/")
        if parts[0] == "layers":
            for i in range(leaf.shape[0]):
                out[".".join(["layers", str(i)] + parts[1:])] = leaf[i]
        else:
            out[".".join(parts)] = leaf
    return out


def projection_from_numpy(projection, device=None) -> torch.Tensor:
    """The reference's (n, sketch_dim) JL projection, already scaled by
    1/sqrt(sketch_dim), as the port's ``projection=`` argument."""
    proj = tensor_from_numpy(projection, device, torch.float32)
    if proj.ndim != 2:
        raise ValueError(f"projection must be (n, sketch_dim), got "
                         f"{tuple(proj.shape)}")
    return proj


def centers_from_numpy(centers, device=None) -> torch.Tensor:
    """(k, d) centers (for ``init="warm"``, or IFCA's initial models) as
    fp32 tensors."""
    c = tensor_from_numpy(centers, device, torch.float32)
    if c.ndim != 2:
        raise ValueError(f"centers must be (k, d), got {tuple(c.shape)}")
    return c


class RowReplay:
    """A row sampler (``sampler(generator, m, n)``, as ``device_kmeans``
    and ``kmeans`` take it) that hands out given draws in order and
    ignores the generator: the reference's ``random`` init rows first
    (where the run has that init), then one draw per minibatch iteration.
    ``calls`` counts the draws taken."""

    def __init__(self, *draws):
        self._draws = [np.asarray(d, np.int64) for d in draws]
        self.calls = 0

    def __call__(self, generator, m: int, n: int) -> torch.Tensor:
        if self.calls >= len(self._draws):
            raise ValueError(f"row draw {self.calls} asked for, only "
                             f"{len(self._draws)} given")
        rows = self._draws[self.calls]
        if rows.shape != (n,) or rows.min() < 0 or rows.max() >= m:
            raise ValueError(f"row draw {self.calls} is {rows.shape} in "
                             f"[{rows.min()}, {rows.max()}], not ({n},) "
                             f"rows of {m}")
        self.calls += 1
        return torch.from_numpy(rows.copy()).to(generator.device)


def rows_from_numpy(*draws) -> RowReplay:
    """The reference's row draws (each an (n,) index array) as a row
    sampler that replays them in order."""
    return RowReplay(*draws)


class DrawReplay:
    """A scenario's draws (the ``mask`` / ``normal`` interface of
    ``utils.prng.KeyedDraws``) handed out from given arrays, ignoring the
    keys: ``masks[tag]`` is the (C,) bool coin of every global client
    index under that role tag, indexed by the indices asked for;
    ``normals[tag]`` a Gaussian block drawn once (the spoof vector) and
    ``normals[(tag, offset)]`` one drawn for the wave at ``offset`` (the
    noise attack, the DP release).  ``calls`` counts the draws taken."""

    def __init__(self, masks=None, normals=None):
        self._masks = {t: np.asarray(m, bool)
                       for t, m in (masks or {}).items()}
        self._normals = {t: np.asarray(n, np.float32)
                         for t, n in (normals or {}).items()}
        self.calls = 0

    def mask(self, key, tag, idx, p) -> torch.Tensor:
        if tag not in self._masks:
            raise ValueError(f"no mask given for tag {tag:#x}")
        self.calls += 1
        coins = torch.from_numpy(self._masks[tag].copy()).to(idx.device)
        return coins[idx]

    def normal(self, key, tag, shape, *, offset=None, device,
               dtype=torch.float32) -> torch.Tensor:
        at = tag if offset is None else (tag, int(offset))
        if at not in self._normals:
            raise ValueError(f"no normal block given for {at}")
        block = self._normals[at]
        if block.shape != tuple(shape):
            raise ValueError(f"normal block {at} is {block.shape}, "
                             f"asked for {tuple(shape)}")
        self.calls += 1
        return torch.from_numpy(block.copy()).to(device, dtype)


def draws_from_numpy(masks=None, normals=None) -> DrawReplay:
    """The reference's scenario draws as a scenario's ``draws=``."""
    return DrawReplay(masks, normals)


def directions_from_numpy(directions, device=None) -> torch.Tensor:
    """The reference's LSH projection directions (one ``(d,)`` normal
    draw per table, stacked to (n_tables, d)) as the ``directions=``
    option of the ``knn-approx`` edge set."""
    dirs = tensor_from_numpy(directions, device, torch.float32)
    if dirs.ndim != 2:
        raise ValueError(f"directions must be (n_tables, d), got "
                         f"{tuple(dirs.shape)}")
    return dirs


def kv_cache_from_numpy(k, v, pos, device=None):
    """The reference's one-layer ``KVCache`` (k and v (b, hkv, capacity,
    dh) numpy arrays, bfloat16 ones included, and its position) -> the
    port's ``models.attention.KVCache`` on ``device``, in the arrays'
    dtype, with ``pos`` a 0-d int32 tensor there."""
    from repro_torch.models.attention import KVCache

    dev = resolve_device(device)
    return KVCache(k=tensor_from_numpy(k, dev), v=tensor_from_numpy(v, dev),
                   pos=torch.as_tensor(int(np.asarray(pos)),
                                       dtype=torch.int32).to(dev))


def model_from_numpy(params, cfg, device=None):
    """The reference's parameter tree of any family (numpy arrays, every
    layer weight stacked on a leading L axis) -> the port's
    ``Transformer`` on ``device``, each leaf in the reference's dtype
    (``transformer.leaf_dtype``: the configuration's, but the fp32 MoE
    router and SSM ``a_log`` / ``d_skip``)."""
    dev = resolve_device(device)

    def convert(tree, prefix):
        if isinstance(tree, dict):
            return {k: convert(v, f"{prefix}/{k}" if prefix else k)
                    for k, v in tree.items()}
        return tensor_from_numpy(tree, dev, leaf_dtype(prefix, cfg))

    tensors = convert(params, "")
    stacked = tensors.pop("layers")
    n = len(tree_leaves(stacked)[0])
    if n != n_stack(cfg):
        raise ValueError(f"{n} stacked layers for a {cfg.n_layers}-layer "
                         f"{cfg.block_pattern} config")
    tensors["layers"] = [tree_map(lambda l: l[i], stacked) for i in range(n)]
    return Transformer(cfg, tensors)
