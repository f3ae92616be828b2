"""Multi-device dry run: place and trace every (arch x input-shape x mesh)
(the port of ``repro/launch/dryrun.py``).

For each combination this shows, without the hardware:
  * the sharding config is coherent: every leaf placed by its spec, every
    op of the step run on DTensors over a 256-rank (512 multi-pod) mesh of
    a fake process group (``launch.mesh``) -- a spec DTensor cannot
    follow fails the trace;
  * the memory footprint per rank (the arguments' local shards, and the
    most bytes the step's own tensors hold at once);
  * per-rank flops, bytes and the collective schedule for the roofline
    report, counted on the local shards (``roofline.ShardCostMode``).

The reference lowers and compiles with XLA on fake host devices; the
port traces the step eagerly under ``FakeTensorMode`` (shapes, dtypes and
devices, no data, nothing allocated), so ``compile_s`` is the trace's
seconds.  Fake tensors live on the mesh's device type: ``cuda`` unless
``--device cpu``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod --json out.json
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch xlstm_125m --shape long_500k --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import inputs as inp
from repro_torch.launch.mesh import (
    axis_sizes,
    data_axes_of,
    make_production_mesh,
    mesh_name,
)
from repro_torch.launch.steps import (
    make_decode_step,
    make_local_train_step,
    make_prefill_step,
    make_train_step,
)
from repro_torch.models import transformer as tr
from repro_torch.roofline.analysis import (
    HW_H100,
    ShardCostMode,
    roofline_terms,
)
from repro_torch.sharding import (
    ShardingRules,
    batch_spec,
    cache_specs,
    opt_state_specs,
    param_specs,
    placements,
)
from repro_torch.sharding.activations import activation_sharding
from repro_torch.sharding.specs import spec_map
from repro_torch.utils import tree_leaves, tree_map, tree_size

# FSDP is a training-memory trade (per-step weight all-gathers).  At
# serve time we replicate weights across the data axes whenever the
# model-parallel shard fits comfortably in HBM -- otherwise every decoded
# token would pay the full FSDP gather tax.
SERVE_FSDP_THRESHOLD_BYTES = 10 * 2 ** 30
LAYOUTS = ("tp_fsdp", "pure_fsdp", "odcl_local", "odcl_local_fsdp")


def make_rules(cfg, mesh, kind: str) -> ShardingRules:
    data_axes = data_axes_of(mesh)
    if kind == "train":
        return ShardingRules(data_axes=data_axes)
    msize = axis_sizes(mesh).get("model", 1)
    n_params = tree_size(tr.abstract_params(cfg))
    bytes_per_dev = n_params * tr.torch_dtype(cfg).itemsize / msize
    return ShardingRules(data_axes=data_axes,
                         fsdp=bytes_per_dev > SERVE_FSDP_THRESHOLD_BYTES)


def layout_rules(layout: str, cfg, mesh, kind: str) -> ShardingRules:
    """The rules of one layout:

      tp_fsdp    -- baseline: tensor parallel over 'model', FSDP+batch
                    over the data axes (``make_rules``).
      pure_fsdp  -- ZeRO-3 style: NO tensor parallelism; every mesh axis
                    acts as a data axis (batch + parameter sharding).
      odcl_local -- the paper-faithful local phase: client axis on
                    'data', per-client parameter replicas (stacked
                    leading dim), zero cross-client collectives.
      odcl_local_fsdp -- each client runs ZeRO-3 over its own column
                    (the model axis) instead of tensor parallelism.
    """
    if layout == "pure_fsdp":
        return ShardingRules(data_axes=tuple(mesh.mesh_dim_names),
                             model_axis=None, fsdp=True)
    if layout in ("odcl_local", "odcl_local_fsdp"):
        if kind != "train":
            raise ValueError(f"{layout} is a training layout")
        if layout == "odcl_local":
            return ShardingRules(data_axes=(), model_axis="model",
                                 fsdp=False, client_axis="data")
        return ShardingRules(data_axes=("model",), model_axis=None,
                             fsdp=True, client_axis="data")
    if layout != "tp_fsdp":
        raise ValueError(f"unknown layout {layout!r}")
    return make_rules(cfg, mesh, kind)


def _local_shape(shape, pl, mesh) -> tuple:
    out = list(shape)
    for i, p in enumerate(pl):
        if p.is_shard():
            n = mesh.size(i)
            if out[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not "
                                 f"divide over {n} ranks")
            out[p.dim] //= n
    return tuple(out)


def place(leaf: torch.Tensor, spec: tuple, mesh) -> DTensor:
    """A fake DTensor of ``leaf``'s global shape and dtype placed by
    ``spec``: only this rank's local shard is made (call under a fake
    tensor mode)."""
    pl = placements(spec, mesh)
    local = torch.empty(_local_shape(leaf.shape, pl, mesh), dtype=leaf.dtype,
                        device=mesh.device_type)
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=leaf.shape,
                              stride=torch.empty(leaf.shape,
                                                 device="meta").stride())


def local_bytes(leaf: torch.Tensor, spec: tuple, mesh) -> int:
    """Bytes of one leaf's local shard under ``spec``."""
    return (math.prod(_local_shape(leaf.shape, placements(spec, mesh), mesh))
            * leaf.element_size())


def _bytes_of(tree) -> int:
    seen, total = set(), 0
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            t = t.to_local() if isinstance(t, DTensor) else t
            st = t.untyped_storage()
            if st._cdata not in seen:
                seen.add(st._cdata)
                total += st.nbytes()
    return total


def _stack(tree, n: int):
    return tree_map(lambda l: inp.sds((n,) + tuple(l.shape), l.dtype), tree)


def lower_one(arch: str, shape_name: str, *, multi_pod: bool = False,
              mesh=None, step_kind: str | None = None, donate: bool = True,
              remat: str = "full", cfg_override=None, unroll: bool = False,
              layout: str = "tp_fsdp", shape: InputShape | None = None):
    """Place and trace one combination.  Returns (costs, info dict): the
    ``ShardCostMode`` of the trace and the reference's info keys.

    ``shape`` overrides ``INPUT_SHAPES[shape_name]`` (a custom batch and
    length); ``mesh`` defaults to the production mesh on the card.
    ``donate`` and ``unroll`` are the reference's and change nothing:
    the port's steps update their arguments in place, and its layers
    are a Python loop.

    The ODCL layouts split the client axis over ``data``, one client a
    rank as in the reference: each rank builds its own client (a stack
    of one, with its share of the batch) on its ``model`` column of the
    mesh and runs ``make_local_train_step`` there, so no op of the step
    can span the ``data`` dim.
    """
    del donate, unroll
    cfg = cfg_override or get_config(arch)
    shape = shape or INPUT_SHAPES[shape_name]
    ok, reason = inp.shape_supported(cfg, shape)
    if not ok:
        return None, {"arch": arch, "shape": shape_name, "status": "SKIP",
                      "reason": reason}

    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    kind = step_kind or shape.kind
    rules = layout_rules(layout, cfg, mesh, kind)
    scfg = inp.serve_config(cfg, shape) if shape.kind == "decode" else cfg
    params_sds = tr.abstract_params(scfg)
    chips = mesh.size()
    name = mesh_name(mesh)

    from torch._subclasses.fake_tensor import FakeTensorMode

    fake = FakeTensorMode(allow_non_fake_inputs=True)
    t0 = time.time()
    with fake:
        if kind == "train" and rules.client_axis is not None:
            # the rank's one client (C = the client axis's size, as the
            # reference's) and its share of the global batch
            n_clients = axis_sizes(mesh)[rules.client_axis]
            col = mesh[tuple(a for a in mesh.mesh_dim_names
                             if a != rules.client_axis)]
            col_rules = dataclasses.replace(rules, client_axis=None)
            pspecs = spec_map(lambda s: (None,) + s, param_specs(
                scfg, params_sds, col_rules, col))
            bspec = batch_spec(scfg, col_rules, col)
            stacked = _stack(params_sds, 1)
            batch = {k: inp.sds((1, shape.global_batch // n_clients)
                                + tuple(v.shape[1:]), v.dtype)
                     for k, v in inp.train_input_specs(scfg, shape).items()}
            args = (
                spec_map(lambda s, l: place(l, s, col), pspecs, stacked),
                spec_map(lambda s, l: place(l, s, col),
                         opt_state_specs(pspecs),
                         inp.abstract_opt_state(stacked) | {
                             "step": inp.sds((1,), torch.int32)}),
                {k: place(v, (None,) + bspec(v[0]), col)
                 for k, v in batch.items()},
            )
            step = make_local_train_step(scfg, remat=remat)
            ctx_mesh = col
        else:
            pspecs = param_specs(scfg, params_sds, rules, mesh)
            bspec = batch_spec(scfg, rules, mesh)
            ctx_mesh = mesh
            params = spec_map(lambda s, l: place(l, s, mesh), pspecs,
                              params_sds)
            if kind == "train":
                args = (params,
                        spec_map(lambda s, l: place(l, s, mesh),
                                 opt_state_specs(pspecs),
                                 inp.abstract_opt_state(params_sds)),
                        {k: place(v, bspec(v), mesh) for k, v in
                         inp.train_input_specs(scfg, shape).items()})
                step = make_train_step(scfg, remat=remat)
            elif kind == "prefill":
                batch = inp.prefill_input_specs(scfg, shape)
                args = (params, {k: place(v, bspec(v), mesh)
                                 for k, v in batch.items()})
                step = make_prefill_step(scfg)
            else:
                cache, tokens = inp.decode_input_specs(cfg, shape)
                cspecs = cache_specs(scfg, cache, rules, mesh)
                args = (params,
                        cache._replace(layers=[
                            {k: place(lay[k], cs[k], mesh) for k in lay}
                            for lay, cs in zip(cache.layers,
                                               cspecs.layers)]),
                        place(tokens, bspec(tokens), mesh))
                step = make_decode_step(scfg)
        costs = ShardCostMode(fake, ShardCostMode.groups_of(mesh))
        costs.exclude(t for t in tree_leaves(args)
                      if isinstance(t, torch.Tensor))
        arg_bytes = _bytes_of(args)
        with activation_sharding(ctx_mesh, rules.data_axes, rules.model_axis):
            with costs:
                out = step(*args)
        out_bytes = _bytes_of(out)
    elapsed = time.time() - t0

    info = {
        "arch": arch, "shape": shape_name, "status": "OK",
        "mesh": name, "chips": chips, "step": kind,
        "compile_s": round(elapsed, 1),
        "argument_bytes_per_device": arg_bytes,
        "output_bytes_per_device": out_bytes,
        "temp_bytes_per_device": costs.peak_temp,
        "peak_bytes_per_device": arg_bytes + costs.peak_temp,
        "flops_per_device": costs.flops,
        "bytes_per_device": costs.bytes,
    }
    coll = costs.collective_bytes()
    report = roofline_terms(
        arch=arch, shape=shape, mesh_name=name, chips=chips,
        cost={"flops": costs.flops, "bytes accessed": costs.bytes},
        collectives=coll, cfg=scfg, params_shape=params_sds, hw=HW_H100,
        bytes_per_device=info["peak_bytes_per_device"])
    info["roofline"] = report.row()
    info["collectives"] = coll
    return costs, info


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--step", default=None,
                    help="override step kind (train|prefill|decode)")
    ap.add_argument("--layout", default="tp_fsdp", choices=list(LAYOUTS))
    ap.add_argument("--json", default=None, help="append results to this file")
    ap.add_argument("--device", default=None,
                    help="the mesh's device type: cuda (default) or cpu")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or args.arch is None) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    combos = [(a, s) for a in archs for s in shapes]

    mesh = make_production_mesh(multi_pod=args.multi_pod, device=args.device)
    results, failed = [], []
    for arch, shape in combos:
        try:
            _, info = lower_one(arch, shape, mesh=mesh, step_kind=args.step,
                                layout=args.layout)
        except Exception as e:  # noqa: BLE001 - report and continue
            info = {"arch": arch, "shape": shape, "status": "FAIL",
                    "error": f"{type(e).__name__}: {e}"}
            failed.append(info)
        results.append(info)
        status = info["status"]
        extra = (info.get("reason") or info.get("error")
                 or f"trace {info.get('compile_s')}s "
                    f"peak/dev {(info.get('peak_bytes_per_device') or 0)/2**30:.2f}GiB")
        print(f"[{status:4s}] {arch:22s} {shape:12s} {extra}", flush=True)
        if args.json:
            with open(args.json, "a") as f:
                f.write(json.dumps(info) + "\n")

    n_ok = sum(r["status"] == "OK" for r in results)
    n_skip = sum(r["status"] == "SKIP" for r in results)
    print(f"\n{n_ok} OK, {n_skip} SKIP, {len(failed)} FAIL "
          f"on mesh {mesh_name(mesh)}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
