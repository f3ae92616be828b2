"""The built-in adversity scenarios: drift, longtail, byzantine, dp (the
port of ``repro/scenarios/library.py``).

Each is a frozen dataclass over the ``Scenario`` hooks
(``scenarios/api.py``), registered at import time.  Role randomness
folds fixed tags into the caller's scenario key, so the same client is
an attacker in ``corrupt_uploads``, ``sketch_transform`` and
``honest_mask``; a coin is keyed by the client's global index, so it is
the same whatever wave the client arrives in.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.scenarios.api import Scenario, register_scenario

# role tags folded into the scenario key per hook: constants, so every
# hook that needs the same role (the Byzantine mask) derives the same
# stream whichever pipeline stage calls it
_TAG_ROLE = 0x0b1e
_TAG_NOISE = 0x6e01
_TAG_SPOOF = 0x5f00
_TAG_DRIFT = 0xd41f
_TAG_DP = 0xd9a0


def _wave_index(offset, w: int, device) -> torch.Tensor:
    """The global client indices of a wave of ``w`` rows at ``offset``."""
    return int(offset) + torch.arange(w, dtype=torch.int64, device=device)


@dataclasses.dataclass(frozen=True)
class DriftScenario(Scenario):
    """Clients migrate source distribution mid-stream.

    Clients at stream position >= ``drift_at * clients`` belong to the
    drifted regime, where a ``drift_frac`` Bernoulli subset draws from its
    cluster shifted by ``shift`` (mod K).  The effective labels are the
    truth for those clients."""
    name: str = "drift"
    drift_frac: float = 0.5
    drift_at: float = 0.5
    shift: int = 1

    def wave_labels(self, key, labels, offset, clients, clusters):
        idx = _wave_index(offset, labels.shape[0], labels.device)
        migrate = self._draws.mask(key, _TAG_DRIFT, idx, self.drift_frac)
        drifted = migrate & (idx >= int(self.drift_at * clients))
        return torch.where(drifted, (labels + self.shift) % clusters, labels)


@dataclasses.dataclass(frozen=True)
class LongtailScenario(Scenario):
    """Zipf cluster occupancy: cluster k holds ~ k^-a of the clients.

    Largest-remainder rounding keeps the occupancy deterministic and every
    cluster nonempty (the admissibility bounds need c_min >= 1)."""
    name: str = "longtail"
    zipf_a: float = 1.2

    def population(self, key, clients, clusters, device=None):
        del key
        if clients < clusters:
            raise ValueError(
                f"longtail occupancy needs clients >= clusters "
                f"({clients} < {clusters})")
        ranks = np.arange(1, clusters + 1, dtype=np.float64)
        p = ranks ** -float(self.zipf_a)
        p /= p.sum()
        counts = np.maximum(np.floor(p * clients).astype(np.int64), 1)
        # largest remainder: hand leftover slots to the largest shares,
        # trim overshoot from the head (which can spare them)
        rem = clients - int(counts.sum())
        order = np.argsort(-(p * clients - np.floor(p * clients)))
        i = 0
        while rem > 0:
            counts[order[i % clusters]] += 1
            rem -= 1
            i += 1
        while rem < 0:
            j = int(np.argmax(counts))
            take = min(int(counts[j]) - 1, -rem)
            counts[j] -= take
            rem += take
        labels = np.repeat(np.arange(clusters), counts)
        return torch.from_numpy(labels).to(resolve_device(device))


@dataclasses.dataclass(frozen=True)
class ByzantineScenario(Scenario):
    """A Bernoulli(``frac``) subset of clients uploads adversarially.

    ``attack='sign_flip'``: attackers upload -theta (the JL sketch is
    linear, so the attack lands in sketch space as the mirrored point).
    ``attack='noise'``: theta + scale * N(0, I), the noise keyed by the
    wave's offset.  ``attack='spoof'``: the parameters are untouched but
    every attacker's sketch row becomes one shared forged vector (a fake
    zero-variance cluster).  Attackers are excluded from
    ``honest_mask``."""
    name: str = "byzantine"
    frac: float = 0.1
    attack: str = "sign_flip"          # sign_flip | noise | spoof
    scale: float = 10.0

    def _role(self, key, idx):
        return self._draws.mask(key, _TAG_ROLE, idx, self.frac)

    def honest_mask(self, key, clients, device=None):
        idx = torch.arange(clients, dtype=torch.int64,
                           device=resolve_device(device))
        return ~self._role(key, idx)

    def corrupt_uploads(self, key, theta, labels, offset, clients):
        del labels, clients
        idx = _wave_index(offset, theta.shape[0], theta.device)
        bad = self._role(key, idx)[:, None]
        if self.attack == "sign_flip":
            return torch.where(bad, -theta, theta)
        if self.attack == "noise":
            noise = self.scale * self._draws.normal(
                key, _TAG_NOISE, tuple(theta.shape), offset=int(offset),
                device=theta.device, dtype=theta.dtype)
            return torch.where(bad, theta + noise, theta)
        if self.attack == "spoof":
            return theta               # spoof forges the sketch channel
        raise ValueError(f"unknown byzantine attack {self.attack!r}")

    def sketch_transform(self, key, sketches, offset):
        if self.attack != "spoof":
            return sketches
        w, s = sketches.shape
        bad = self._role(key, _wave_index(offset, w, sketches.device))[:, None]
        forged = self.scale * self._draws.normal(
            key, _TAG_SPOOF, (s,), device=sketches.device,
            dtype=sketches.dtype)
        return torch.where(bad, forged[None, :], sketches)

    @property
    def transforms_sketches(self) -> bool:
        return self.attack == "spoof"


@dataclasses.dataclass(frozen=True)
class DPScenario(Scenario):
    """(epsilon, delta)-DP release of the sketch uploads.

    One Gaussian mechanism on the JL rows: L2-clip each client's sketch
    to ``clip`` (the sensitivity bound), then add N(0, sigma^2 I) with
    ``sigma = clip * sqrt(2 ln(1.25 / delta)) / epsilon``, the noise keyed
    by the wave's offset.  Applied inside the session's ingest, so the
    clean rows are never stored."""
    name: str = "dp"
    epsilon: float = 1.0
    delta: float = 1e-5
    clip: float = 1.0

    @property
    def sigma(self) -> float:
        return (self.clip * math.sqrt(2.0 * math.log(1.25 / self.delta))
                / self.epsilon)

    def clip_rows(self, sketches) -> torch.Tensor:
        """Each row scaled into the L2 ball of radius ``clip``."""
        norms = torch.linalg.vector_norm(sketches, dim=1, keepdim=True)
        return sketches * torch.clamp_max(
            self.clip / torch.clamp_min(norms, 1e-12), 1.0)

    def sketch_transform(self, key, sketches, offset):
        noise = self.sigma * self._draws.normal(
            key, _TAG_DP, tuple(sketches.shape), offset=int(offset),
            device=sketches.device, dtype=sketches.dtype)
        return self.clip_rows(sketches) + noise


for _s in (DriftScenario(), LongtailScenario(), ByzantineScenario(),
           DPScenario()):
    register_scenario(_s)
del _s
