"""The plain reference of the benchmark's cells: the same server round,
written again in plain PyTorch from Algorithm 1 and the paper's two
clustering steps.  It imports neither ``jax``, nor ``repro``, nor
anything of ``repro_torch``, and takes nothing the program made: the
benchmark hands it the uploads and the projection it handed the
program.

Every function takes a ``precision``: ``"fp64"`` (the ruler the
program's outputs are judged by) or ``"tf32"`` (fp32 with TF32 products:
the control, the nearest precision below the fp32 the configurations
state).
"""
from __future__ import annotations

import contextlib

import torch

PRECISIONS = ("fp64", "tf32")


@contextlib.contextmanager
def precision(name: str):
    """Compute in ``name``: yields the dtype, with TF32 products on for
    ``"tf32"`` and off for ``"fp64"``; the flags are restored after."""
    if name not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, "
                         f"got {name!r}")
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    tf32 = name == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield torch.float64 if name == "fp64" else torch.float32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def sketch(models: torch.Tensor, projection: torch.Tensor,
           prec: str = "fp64") -> torch.Tensor:
    """Step 1's JL sketch of every client: (C, d) @ (d, s)."""
    with precision(prec) as dtype:
        return models.to(dtype) @ projection.to(dtype)


def cluster_means(x: torch.Tensor, labels: torch.Tensor, k: int,
                  prec: str = "fp64") -> tuple:
    """Steps 3-4: the mean of ``x`` (C, n) over each of the clusters
    ``labels`` in [0, k) names (the one-hot product), and each cluster's
    count.  An empty cluster's mean is 0."""
    with precision(prec) as dtype:
        onehot = torch.nn.functional.one_hot(labels.long(), k).to(dtype)
        counts = onehot.sum(dim=0)
        sums = onehot.T @ x.to(dtype)
        return sums / torch.clamp_min(counts, 1.0)[:, None], counts


def gather_back(labels: torch.Tensor, table: torch.Tensor,
                prec: str = "fp64") -> torch.Tensor:
    """Step 4's hand-back: each client's row of its cluster's ``table``
    entry, as the paper's round writes it, the one-hot product
    ``onehot @ table`` (exact in fp64 and fp32, rounded in TF32)."""
    with precision(prec) as dtype:
        onehot = torch.nn.functional.one_hot(labels.long(),
                                             table.shape[0]).to(dtype)
        return onehot @ table.to(dtype)


def rel_err(x: torch.Tensor, ref: torch.Tensor) -> float:
    """max |x - ref| over max |ref|, in float64."""
    ref = ref.to(torch.float64)
    x = x.to(ref.device, torch.float64)
    if x.shape != ref.shape:
        return float("inf")
    return float((x - ref).abs().max() / ref.abs().max().clamp_min(1e-300))
