"""Keyed, counter-based random draws that give the same bits on every
device (the port's counterpart of JAX's ``fold_in`` keys).

A key is a Python int in [0, 2^32).  ``fold_in(key, data)`` derives a new
key from a key and an integer, or a tensor of keys from a tensor of
integers; ``bits(key, idx)`` hashes a tensor of counters.  The hash is
Wellons' ``lowbias32`` (two rounds of xor-shift and multiply, a bijection
of 32-bit words) computed in int64 tensor ops: every 32-bit product is
split into two 16-bit halves so that no intermediate value leaves
[0, 2^49), and the CPU and CUDA compute the same integers.

``key_fold`` and ``split_like`` are the reference's two derivations
(``repro/utils/prng.py``) over these keys.

On top of them: ``uniform`` (24-bit floats in [0, 1)), ``bernoulli``
(an integer threshold on the same 24 bits) and ``normal`` (Box-Muller in
float64, then cast).  A draw keyed by a client's global index is the
same whatever wave the client arrives in.

``KeyedDraws`` bundles the two draws the scenarios make (a Bernoulli
coin per global index, a Gaussian block per key) behind one interface;
``repro_torch.interop.draws_from_numpy`` replays given draws through the
same interface.

The draws are not JAX's threefry draws: parity tests carry those across.
"""
from __future__ import annotations

import math

import torch

from repro_torch.utils.tree import tree_leaves, tree_map

MASK32 = 0xFFFFFFFF
_U24 = 1.0 / (1 << 24)


def _mul32(x, c: int):
    """(x * c) mod 2^32 for x in [0, 2^32), without a 64-bit overflow."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK32


def mix32(x):
    """Wellons' lowbias32 on a Python int or an int64 tensor of words in
    [0, 2^32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def key(seed: int) -> int:
    """The root key of ``seed``."""
    return mix32((int(seed) & MASK32) ^ 0x5EED5EED)


def _word(data):
    if isinstance(data, torch.Tensor):
        return data.to(torch.int64) & MASK32
    data = int(data)
    if not 0 <= data <= MASK32:
        raise ValueError(f"fold_in data must lie in [0, 2^32), got {data}")
    return data


def fold_in(key_: int, data):
    """A key derived from ``key_`` and ``data`` (an int, or an integer
    tensor giving one key per element)."""
    return mix32(mix32(int(key_) ^ 0x9E3779B9) ^ _word(data))


def key_fold(key_: int, *data: int) -> int:
    """Fold a sequence of ints into a key, one ``fold_in`` each (a stable
    derivation: the same ints give the same key)."""
    for d in data:
        key_ = fold_in(key_, d)
    return key_


def split_like(key_: int, tree):
    """One key per leaf of ``tree`` (``fold_in(key_, i)`` for the i-th leaf
    in ``tree_leaves`` order), returned in the tree's structure."""
    keys = iter([fold_in(key_, i) for i in range(len(tree_leaves(tree)))])
    return tree_map(lambda _: next(keys), tree)


def bits(key_: int, idx: torch.Tensor) -> torch.Tensor:
    """32 random bits (int64 in [0, 2^32)) per counter of ``idx``."""
    return fold_in(key_, idx)


def uniform(key_: int, idx: torch.Tensor) -> torch.Tensor:
    """float32 in [0, 1) on a grid of 2^-24, one per counter of ``idx``."""
    return (bits(key_, idx) >> 8).to(torch.float32) * _U24


def bernoulli(key_: int, idx: torch.Tensor, p: float) -> torch.Tensor:
    """A bool per counter of ``idx``, true with probability ``p`` (to a
    grid of 2^-24): an integer comparison, the same on every device."""
    return (bits(key_, idx) >> 8) < int(round(float(p) * (1 << 24)))


def normal(key_: int, shape, *, device, dtype=torch.float32) -> torch.Tensor:
    """Standard normal draws of ``shape`` (Box-Muller over the element
    counters, in float64, then cast to ``dtype``)."""
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    # 1 - u lies in (0, 1], exactly: the grid of 2^-24 is closed under it
    u1 = 1.0 - uniform(fold_in(key_, 1), idx).to(torch.float64)
    u2 = uniform(fold_in(key_, 2), idx).to(torch.float64)
    z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)
    return z.to(dtype).reshape(tuple(shape))


class KeyedDraws:
    """The scenarios' draws: ``mask`` is a Bernoulli coin per global
    client index under ``fold_in(key, tag)``; ``normal`` a Gaussian block
    under ``fold_in(key, tag)``, folded once more with ``offset`` where
    the draw belongs to one wave."""

    def mask(self, key_: int, tag: int, idx: torch.Tensor,
             p: float) -> torch.Tensor:
        return bernoulli(fold_in(key_, tag), idx, p)

    def normal(self, key_: int, tag: int, shape, *, offset=None, device,
               dtype=torch.float32) -> torch.Tensor:
        k = fold_in(key_, tag)
        if offset is not None:
            k = fold_in(k, offset)
        return normal(k, shape, device=device, dtype=dtype)


KEYED = KeyedDraws()
