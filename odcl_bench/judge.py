"""What decides ``correct``: the outputs of the served round at the close
of the window, judged against the plain reference
(``odcl_bench/reference``), which works them out again in float64 from
the uploads and the projection the benchmark handed the program.

Numbers compared (each against the configuration's ``limits``):

  * ``live_miss``: the clients the session holds against those the
    schedule keeps live (the mix's ``max_age``: a row goes once that
    many waves have passed since its last write), counted both ways;
  * ``stale_rounds``: rounds run since the round that is served;
  * ``sketch_err``: the session's live sketch rows, every row the
    ingests wrote, against the reference's sketch of each client's
    latest upload (largest error over the largest reference magnitude);
  * the partition, by the configuration's reference family
    (``reference/<family>.py``'s ``judge``): ``label_miss``,
    ``center_err`` and ``cluster_shortfall`` (ODCL-KM: every row's label
    names its nearest served center, the centers are the means of the
    rows they label, and a cold round serves all k clusters) or
    ``partition_miss`` and ``center_err`` (ODCL-CC: the reference's AMA
    partition and its centers);
  * ``model_err``: the served cluster models and every client's row of
    the new parameters, against the per-cluster means of the uploads;
  * ``seeding_miss_share`` (cold rounds of a family with an objective,
    :func:`seeding`): the share of a sample of the window's rounds whose
    served centers are worse than the reference's best of a few draws.
"""
from __future__ import annotations

import importlib
import math

import numpy as np
import torch

from odcl_bench.reference import cluster_means, gather_back, rel_err, sketch

# the seeding's quality: rounds drawn from the window, the reference's
# draws a round, and the share of its objective that counts as worse
SEEDING_SAMPLE = 32
SEEDING_DRAWS = 3
SEEDING_MARGIN = 1e-3


def family(cfg: dict):
    """The configuration's reference family module."""
    return importlib.import_module(f"odcl_bench.reference.{cfg['reference']}")


def compare(cfg: dict, out: dict, up, lam) -> tuple:
    """The numbers compared, for outputs ``out`` (``round``, ``last``,
    ``ids`` (C',) in row order, ``sketches`` (C', s), ``labels`` (C',)
    in [0, K'), ``centers`` (K', s), ``models`` (K', d),
    ``client_models`` (C', d)) of the uploads ``up``
    (``inputs.Uploads``), and what the reference learned on the way
    (the AMA's ``n_iter``)."""
    want, live = up.live(out["last"])
    ids = np.asarray(out["ids"])
    values = {"live_miss": int(np.setxor1d(want, ids).size),
              "stale_rounds": out["last"] - out["round"]}
    labels = torch.as_tensor(out["labels"]).long()
    if values["live_miss"] or values["stale_rounds"] or \
            labels.numel() != ids.size:
        # nothing to line the rows up with
        values.update({name: math.inf for name in cfg["limits"]
                       if name not in values and name != "seeding_miss_share"})
        return values, {}
    live = live[torch.as_tensor(np.searchsorted(want, ids),
                                device=live.device)]
    a = sketch(live, up.projection, "fp64")
    labels = labels.to(a.device)
    k = int(out["centers"].shape[0])
    if int(labels.min()) < 0 or int(labels.max()) >= k or \
            torch.unique(labels).numel() != k:
        raise ValueError(f"the round labels its clients outside the {k} "
                         "clusters it serves")
    values["sketch_err"] = rel_err(out["sketches"], a)
    partition, ref = family(cfg).judge(a, labels, out["centers"], cfg, lam,
                                       warm=out.get("warm", False))
    values.update(partition)
    means, _ = cluster_means(live, labels, k, "fp64")
    values["model_err"] = max(rel_err(out["models"], means),
                              rel_err(out["client_models"], means[labels]))
    return values, ref


def seeding(cfg: dict, up, centers: dict, generator: torch.Generator) -> dict:
    """``seeding_miss_share``: over up to ``SEEDING_SAMPLE`` of the rounds
    in ``centers`` (round -> the centers it served), drawn with
    ``generator``, the share whose centers' objective over that round's
    live clients (fp64) exceeds by more than ``SEEDING_MARGIN`` the best
    of ``SEEDING_DRAWS`` of the reference's clusterings of them.  Empty
    for a family without an objective or without rounds."""
    fam = family(cfg)
    if not hasattr(fam, "objective") or not centers:
        return {}
    rounds = sorted(centers)
    pick = torch.randperm(len(rounds), generator=generator,
                          device=generator.device)[:SEEDING_SAMPLE].tolist()
    misses = 0
    for i in pick:
        _, live = up.live(rounds[i])
        a = sketch(live, up.projection, "fp64")
        best = min(fam.objective(a, fam.control(a, cfg, None, generator,
                                                "fp64")[1])
                   for _ in range(SEEDING_DRAWS))
        misses += fam.objective(a, centers[rounds[i]]) > best * (
            1.0 + SEEDING_MARGIN)
    return {"seeding_miss_share": misses / len(pick)}


def control_outputs(cfg: dict, up, g: int, lam,
                    generator: torch.Generator) -> dict:
    """The control: the reference put in the program's place and computed
    in TF32 (the precision below the configurations' fp32) over the
    clients live after round ``g``, with the outputs a round of the
    program hands back."""
    ids, live = up.live(g)
    a = sketch(live, up.projection, "tf32")
    labels, centers = family(cfg).control(a, cfg, lam, generator, "tf32")
    models, _ = cluster_means(live, labels, int(centers.shape[0]), "tf32")
    return {"round": g, "last": g, "ids": ids, "sketches": a,
            "labels": labels, "centers": centers, "models": models,
            "client_models": gather_back(labels, models, "tf32")}


def checks(values: dict, limits: dict) -> tuple:
    """``(correct, {name: {"value", "limit"}})``: every number at or
    under its limit, and a limit for every number."""
    out = {}
    for name, value in values.items():
        out[name] = {"value": value, "limit": limits.get(name)}
    correct = all(c["limit"] is not None and c["value"] <= c["limit"]
                  for c in out.values())
    return correct, out
