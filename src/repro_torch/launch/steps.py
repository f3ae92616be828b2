"""Training steps (the port of ``repro/launch/steps.py``).

  * ``make_train_step``       one model: loss, gradients, AdamW.
  * ``make_local_train_step`` the paper's local-ERM phase over a stacked
    federation (every leaf has a leading client axis C): each client's
    step runs on views of its slices of the stacked parameters and
    moments, so gradients never cross the client axis and no step
    copies C whole models.
  * ``make_aggregate_step``   the one-shot clustered aggregation as one
    call: sketch, k-means, per-cluster parameter mean.
  * ``make_eval_batch``       a held-out per-client batch.
  * ``make_prefill_step`` / ``make_decode_step`` -- serving, as the dry
    run traces it: the prefill's attention is ``train_attention`` (the
    reference's jnp paths, as its dry run lowers them), since the flash
    kernel cannot run on fake tensors.

The reference's ``unroll`` (a ``lax.scan`` unrolled) is accepted and
does nothing: the port's layers are a Python loop.

Steps update the parameters and the AdamW state IN PLACE (the reference
returns new arrays): at qwen2-0.5b a second copy of C models and their
fp32 moments would not fit beside the first on one card.  Each returns
``(loss, params, opt_state)`` with the same tensors it was given.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models.transformer import (
    decode_step,
    forward,
    model_view,
    train_loss,
)
from repro_torch.optim import AdamWConfig, adamw_update_
from repro_torch.utils import tree_leaves, tree_map


def _as_batch(batch: dict, device) -> dict:
    """A batch of numpy arrays or tensors -> tensors on ``device``: token
    ids and labels int64, masks bool, frames and patch embeddings as
    they come."""
    def one(v):
        t = torch.as_tensor(v)
        if t.is_floating_point() or t.dtype == torch.bool:
            return t.to(device)
        return t.to(device, torch.long)

    return {k: one(v) for k, v in batch.items()}


def _live_leaf(leaf: torch.Tensor, per_layer: bool):
    """A leaf autograd differentiates: a detached view, or for a weight
    stacked on L one view a layer (the forward reads the layers one by
    one; a gradient taken of the stacked leaf would zero-fill and add a
    full-size buffer for every layer)."""
    if per_layer:
        return [leaf[i].detach().requires_grad_(True)
                for i in range(leaf.shape[0])]
    return leaf.detach().requires_grad_(True)


def _like(grad: torch.Tensor, param: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient redistributed to its parameter's placements (the
    reference's ``out_shardings``); any other gradient as it is."""
    if isinstance(param, DTensor):
        return grad.redistribute(param.device_mesh, param.placements)
    return grad


def _one_model_step(params, opt_state, batch, cfg, opt_cfg, remat):
    """Loss and gradients of one model, then AdamW in place."""
    live = {k: tree_map(lambda l, k=k: _live_leaf(l, k == "layers"),
                        params[k])
            for k in sorted(params)}
    loss = train_loss(live, cfg, batch, remat=remat)
    # a leaf the loss does not read (the token embedding of an audio
    # encoder) gets a zero gradient, as ``jax.grad`` gives it
    it = iter(torch.autograd.grad(loss, tree_leaves(live), allow_unused=True,
                                  materialize_grads=True))
    grads = {k: tree_map(lambda l, k=k: _like(
                 torch.stack([next(it) for _ in range(l.shape[0])])
                 if k == "layers" else next(it), l), params[k])
             for k in sorted(params)}
    adamw_update_(params, grads, opt_state, opt_cfg)
    return loss.detach()


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig | None = None,
                    remat: str = "full", unroll: bool = False) -> Callable:
    """``train_step(params, opt_state, batch) -> (loss, params,
    opt_state)`` for one model."""
    opt_cfg = opt_cfg or AdamWConfig()

    def train_step(params, opt_state, batch):
        batch = _as_batch(batch, tree_leaves(params)[0].device)
        loss = _one_model_step(params, opt_state, batch, cfg, opt_cfg, remat)
        return loss, params, opt_state

    return train_step


def client_slice(tree, c: int):
    """Client ``c``'s model: a view of every stacked leaf (the step leaf
    of a stacked AdamW state becomes a 0-d view)."""
    return tree_map(lambda l: l[c], tree)


def make_local_train_step(cfg: ModelConfig,
                          opt_cfg: AdamWConfig | None = None,
                          remat: str = "full",
                          unroll: bool = False) -> Callable:
    """ODCL's local phase: ``local_step(params_c, opt_state_c, batch_c) ->
    (losses, params_c, opt_state_c)`` over stacked parameters, moments
    and (C, b, s) batches, one client after another.

    On a federation sharded over a mesh (``Shard(0)`` DTensors,
    ``sharding.clients.tree_axis``) each rank steps only its own clients,
    on views of its local shards and its own rows of the batch: a step
    sends no collective.  The losses are then this rank's clients'
    (``ClientAxis.gather_clients`` gives every client's); the stacks come
    back with their placements."""
    from repro_torch.sharding.clients import tree_axis

    opt_cfg = opt_cfg or AdamWConfig()

    def local_step(params_c, opt_state_c, batch_c):
        axis = tree_axis(params_c)
        n = int(tree_leaves(params_c)[0].shape[0])
        params, opt_state = axis.mine(params_c, n), axis.mine(opt_state_c, n)
        batch_c = _as_batch(axis.mine(batch_c, n),
                            tree_leaves(params)[0].device)
        c = int(tree_leaves(params)[0].shape[0])
        losses = [_one_model_step(client_slice(params, i),
                                  client_slice(opt_state, i),
                                  client_slice(batch_c, i), cfg, opt_cfg,
                                  remat)
                  for i in range(c)]
        return torch.stack(losses), params_c, opt_state_c

    return local_step


def make_aggregate_step(cfg: ModelConfig, k: int, sketch_dim: int = 256,
                        kmeans_iters: int = 32) -> Callable:
    """The one-shot clustered aggregation as one call:
    ``aggregate_step(params_c, seed) -> (new_params, labels)``.  Sketches
    every client (the JL projection drawn from ``seed``, streamed),
    clusters the (C, sketch_dim) matrix with k-means++ and Lloyd, and
    replaces every client's parameters with its cluster's mean."""
    from repro_torch.core.clustering.kmeans import kmeans
    from repro_torch.core.federated import cluster_average_tree
    from repro_torch.core.sketch import make_generator, sketch_stacked

    def aggregate_step(params_c, seed: int):
        sketches = sketch_stacked(params_c, sketch_dim=sketch_dim, seed=seed)
        res = kmeans(make_generator(seed, sketches.device), sketches, k,
                     iters=kmeans_iters)
        onehot = torch.nn.functional.one_hot(
            torch.as_tensor(res.labels, device=sketches.device).long(),
            k).to(torch.float32)
        counts = torch.clamp_min(torch.sum(onehot, dim=0), 1.0)
        return cluster_average_tree(params_c, onehot, counts), res.labels

    return aggregate_step


def make_prefill_step(cfg: ModelConfig, unroll: bool = False) -> Callable:
    """``prefill_step(params, batch) -> logits`` (b, s, V) of one model."""
    def prefill_step(params, batch):
        with torch.no_grad():
            return forward(model_view(params, cfg), cfg, batch,
                           attention=attn_lib.train_attention)[0]

    return prefill_step


def make_decode_step(cfg: ModelConfig, unroll: bool = False) -> Callable:
    """``decode_one(params, cache, tokens) -> (logits, cache)``: one token
    against a ``DecodeCache``."""
    def decode_one(params, cache, tokens):
        with torch.no_grad():
            return decode_step(model_view(params, cfg), cfg, cache, tokens)

    return decode_one


def make_eval_batch(stream, *, n_clients: int, batch: int, seq_len: int,
                    step: int = 999_999) -> dict:
    """A held-out per-client eval batch from a ``ClusteredTokenStream``,
    drawn at a step far beyond any training step."""
    toks = np.stack([stream.sample(c, batch, seq_len, step=step)
                     for c in range(n_clients)])
    return {"tokens": toks[:, :, :-1], "labels": toks[:, :, 1:]}
