"""The cells' inputs, made on the device from the run's seed.

Frozen copies of the program's upload generator
(``repro_torch/launch/simulate.py``: ``staggered_optima``,
``wave_ridge_erm``; ``repro_torch/core/erm.py``: ``batched_ridge_erm``)
and of the recovery interval (17) (``repro_torch/core/clustering/
convex.py``: ``lambda_interval``), so a later change to the program's
generator cannot change the benchmark's traffic.  ``odcl_bench/tests``
holds each copy equal to its original.

Every stream of draws has its own ``torch.Generator``, seeded from the
run's seed and a fixed tag (:func:`subseed`), so the same seed gives the
same inputs whatever else a run draws.
"""
from __future__ import annotations

import math

import numpy as np
import torch

_MASK63 = (1 << 63) - 1


def subseed(seed: int, tag: int) -> int:
    """A 63-bit seed for the stream ``tag`` of a run seeded with ``seed``
    (any integer: the driver's exceed 32 bits): splitmix64 of the pair."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(tag) * 0xBF58476D1CE4E5B9
         + 0x94D049BB133111EB) & ((1 << 64) - 1)
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & ((1 << 64) - 1)
    return (z ^ (z >> 31)) & _MASK63


def generator(seed: int, tag: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(subseed(seed, tag))


def staggered_optima(generator: torch.Generator, K: int, d: int):
    """Well-separated cluster optima in the style of Appendix E.1:
    cluster k draws coordinate magnitudes from U([k + 1, k + 2]) with an
    independent random sign per coordinate."""
    dev = generator.device
    signs = torch.randint(0, 2, (K, d), generator=generator,
                          device=dev).to(torch.float32) * 2.0 - 1.0
    base = torch.arange(1.0, K + 1.0, dtype=torch.float32, device=dev)[:, None]
    return signs * (base + torch.rand((K, d), generator=generator,
                                      device=dev))


def batched_ridge_erm(x: torch.Tensor, y: torch.Tensor,
                      reg: float = 1e-6) -> torch.Tensor:
    """Every client's ridge ERM at once: x (w, n, d), y (w, n) ->
    (w, d), one solve over the (w, d, d) Gram stack."""
    n, d = x.shape[1], x.shape[2]
    eye = torch.eye(d, dtype=x.dtype, device=x.device)
    gram = x.mT @ x / n + reg * eye
    rhs = (x.mT @ y[..., None]) / n
    return torch.linalg.solve(gram, rhs)[..., 0]


def wave_ridge_erm(generator: torch.Generator, optima, labels, *, n: int,
                   noise: float = 1.0, reg: float = 1e-6):
    """One wave of step 1: draw each client's (n, d) covariates and noisy
    responses from its cluster's optimum, solve every ridge ERM.
    Returns the (wave, d) stack of local models on the optima's device."""
    w, d = labels.shape[0], optima.shape[1]
    x = torch.randn((w, n, d), generator=generator, device=optima.device)
    z = torch.einsum("wnd,wd->wn", x, optima[labels])
    y = z + noise * torch.randn((w, n), generator=generator,
                                device=optima.device)
    return batched_ridge_erm(x, y, reg)


def lambda_interval(points, labels) -> tuple[float, float]:
    """Recovery interval (17) for a candidate clustering:

    [ max_k diam(V_k)/|V_k| ,  min_{k!=l} ||c_k - c_l|| / (2n - |V_k| - |V_l|) )

    Returns (lo, hi); the interval is non-empty iff lo < hi.  Host NumPy
    in float64."""
    if isinstance(points, torch.Tensor):
        points = points.cpu().numpy()
    points = np.asarray(points, np.float64)
    labels = np.asarray(labels)
    n = points.shape[0]
    ks = np.unique(labels)
    lo = 0.0
    cents, sizes = [], []
    for k in ks:
        pk = points[labels == k]
        sizes.append(len(pk))
        cents.append(pk.mean(axis=0))
        if len(pk) > 1:
            # the largest pairwise distance, 256 rows at a time
            d2max = 0.0
            for s in range(0, len(pk), 256):
                blk = pk[s:s + 256]
                d2 = ((blk[:, None] - pk[None, :]) ** 2).sum(-1)
                d2max = max(d2max, float(d2.max()))
            diam = float(np.sqrt(d2max))
        else:
            diam = 0.0
        lo = max(lo, diam / len(pk))
    hi = np.inf
    for a in range(len(ks)):
        for b in range(a + 1, len(ks)):
            dist = float(np.linalg.norm(cents[a] - cents[b]))
            hi = min(hi, dist / (2 * n - sizes[a] - sizes[b]))
    if len(ks) == 1:
        hi = np.inf
    return lo, hi


class Uploads:
    """A cell's uploads, all on the device, and the schedule of its rounds.

    The federation is ``clients`` ids in ``blocks`` blocks of ``wave``
    (``reupload_share`` of the clients); the set-up fills every block
    with models drawn around the planted optima.  Round g is
    ``mutation_rounds`` steps; step s (counted over the run) re-uploads
    block ``s mod blocks`` and, with ``churn``, brings ``churn`` new ids
    (``clients + churn s + i``).  Every upload of round g comes from pool
    entry ``g mod pool``, drawn around its own shifted optima (the optima
    plus ``drift_scale`` times a normal draw), with ``probes``
    never-seen clients of the same shift for the route that moves the
    drift gauge.  A client's true cluster is its id mod K.  With
    ``max_age`` the session evicts a row once more than ``max_age``
    waves have passed since its last write; every ingest is one wave."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        c, k, d = cfg["clients"], cfg["clusters"], cfg["dim"]
        self.clients, self.k = c, k
        self.wave = round(c * mix["reupload_share"])
        self.churn, self.max_age = int(mix["churn"]), mix["max_age"]
        self.steps = int(mix["mutation_rounds"])
        if c % self.wave or self.wave % k or self.churn % k:
            raise ValueError(f"a wave of {self.wave} must divide C = {c}, "
                             f"and it and the churn of {self.churn} must "
                             f"be multiples of K = {k}")
        if self.churn and self.max_age is None:
            raise ValueError("joiners without a max_age outgrow the session")
        self.blocks = c // self.wave
        self.waves_a_step = 2 if self.churn else 1
        # the planted optima are the deployment's (the config's seed);
        # everything a client draws comes from the run's seed
        self.optima = staggered_optima(
            torch.Generator(device=device).manual_seed(cfg["optima_seed"]),
            k, d)
        self.labels = torch.arange(self.wave, device=device) % k
        gen = generator(seed, 1, device)

        def draw(optima, n):
            return wave_ridge_erm(gen, optima,
                                  torch.arange(n, device=device) % k,
                                  n=cfg["samples"], noise=cfg["noise"],
                                  reg=cfg["reg"])

        n_pool = int(mix["pool"])
        shifts = [self.optima] * n_pool
        if mix["drift_scale"]:
            sgen = generator(seed, 4, device)
            shifts = [self.optima + mix["drift_scale"] * torch.randn(
                self.optima.shape, generator=sgen, device=device)
                for _ in shifts]
        self.init = [draw(self.optima, self.wave) for _ in range(self.blocks)]
        self.pool, self.joiners, self.probes = [], [], []
        for shifted in shifts:
            self.pool.append([draw(shifted, self.wave)
                              for _ in range(self.steps)])
            if self.churn:
                self.joiners.append([draw(shifted, self.churn)
                                     for _ in range(self.steps)])
            if mix["probes"]:
                self.probes.append(draw(shifted, int(mix["probes"])))
        s = cfg["sketch_dim"]
        self.projection = torch.randn(
            (d, s), generator=generator(seed, 2, device), device=device,
            dtype=torch.float32) / math.sqrt(s)

    @property
    def capacity(self) -> int:
        """Rows the session needs: the federation, and the joiners of a
        step that arrive before that step's evictions."""
        return self.clients + self.churn

    def round_waves(self, g: int) -> list:
        """Round g's waves, in order: ``[(ids, models), ...]``."""
        p, waves = g % len(self.pool), []
        for j in range(self.steps):
            s = g * self.steps + j
            b = s % self.blocks
            waves.append((range(b * self.wave, (b + 1) * self.wave),
                          self.pool[p][j]))
            if self.churn:
                first = self.clients + self.churn * s
                waves.append((range(first, first + self.churn),
                              self.joiners[p][j]))
        return waves

    def probe_wave(self, g: int):
        return self.probes[g % len(self.probes)]

    def live(self, g: int) -> tuple:
        """``(ids, models)``: the clients the session holds after round
        g's waves (``g = -1``: after the fill) and each one's latest
        upload, ids ascending."""
        end = (g + 1) * self.steps - 1          # the last step run
        clock = self.blocks + (end + 1) * self.waves_a_step

        def alive(stamp):
            return self.max_age is None or clock - stamp <= self.max_age

        def upload(s):
            return self.pool[(s // self.steps) % len(self.pool)][
                s % self.steps]

        ids, models = [], []
        for b in range(self.blocks):
            last = end - (end - b) % self.blocks
            if last >= 0:
                stamp = self.blocks + 1 + last * self.waves_a_step
                rows = upload(last)
            else:
                stamp, rows = b + 1, self.init[b]
            if alive(stamp):
                ids.append(np.arange(b * self.wave, (b + 1) * self.wave))
                models.append(rows)
        if self.churn:
            for s in range(max(0, end - self.max_age), end + 1):
                if alive(self.blocks + 2 + s * 2):
                    ids.append(self.clients + self.churn * s
                               + np.arange(self.churn))
                    models.append(self.joiners[
                        (s // self.steps) % len(self.pool)][s % self.steps])
        return np.concatenate(ids), torch.cat(models, dim=0)
