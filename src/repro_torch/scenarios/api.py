"""The Scenario registry: adversity as composable population transforms
(the port of ``repro/scenarios/api.py``).

A ``Scenario`` is a bundle of hooks over the synthetic client
population, each bound to one stage of the pipeline:

  ``population(key, clients, clusters, device=)``
      the (C,) true cluster occupancy, before any data is drawn
      (``longtail`` replaces the balanced round-robin with a Zipf law).
  ``wave_labels(key, labels, offset, clients, clusters)``
      per-wave relabeling before data generation (``drift`` migrates
      late-stream clients; the stream position is the wave offset).
  ``corrupt_uploads(key, theta, labels, offset, clients)``
      the step-1 upload attack on the (w, d) stack of local ERMs
      (``byzantine`` sign-flips or noises the attackers' models).
  ``sketch_transform(key, sketches, offset)``
      applied to the (w, sketch_dim) JL rows inside the session's ingest
      (``dp`` clips and noises them, ``byzantine``'s spoof forges them).
  ``honest_mask(key, clients, device=)``
      which clients count toward quality metrics.

Keys are the port's counter-based keys (``utils/prng.py``): a scenario
folds fixed role tags into the one key the caller passes, so the
attacker flagged in ``corrupt_uploads`` is the client flagged in
``honest_mask``.  Every scenario takes its draws from ``draws`` (the
keyed draws by default; ``interop.draws_from_numpy`` replays given ones,
which is how tests carry the reference's across).  The base class is the
identity scenario ("none").

``build_scenario("byzantine+dp", frac=0.1, epsilon=2.0)`` resolves a
'+'-chain into a ``ComposedScenario``, each member keeping only the
dataclass fields it declares from one flat option set.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Protocol, runtime_checkable

import torch

from repro_torch.device import resolve_device
from repro_torch.utils import prng


@runtime_checkable
class ScenarioLike(Protocol):
    """Anything with the five population hooks (see module docstring)."""
    name: str

    def population(self, key, clients: int, clusters: int, device=None): ...
    def wave_labels(self, key, labels, offset, clients: int,
                    clusters: int): ...
    def corrupt_uploads(self, key, theta, labels, offset, clients: int): ...
    def sketch_transform(self, key, sketches, offset): ...
    def honest_mask(self, key, clients: int, device=None): ...


@dataclasses.dataclass(frozen=True)
class Scenario:
    """The identity client population: every hook is a passthrough.

    Subclasses override the hooks they bend; frozen dataclasses keep
    instances hashable (``draws`` is left out of equality and hash)."""
    name: str = "none"
    draws: Any = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def _draws(self):
        return prng.KEYED if self.draws is None else self.draws

    def population(self, key, clients: int, clusters: int,
                   device=None) -> torch.Tensor:
        """(C,) int64 true cluster per client (balanced round-robin)."""
        del key
        return torch.arange(clients, device=resolve_device(device)) % clusters

    def wave_labels(self, key, labels, offset, clients: int,
                    clusters: int) -> torch.Tensor:
        del key, offset, clients, clusters
        return labels

    def corrupt_uploads(self, key, theta, labels, offset,
                        clients: int) -> torch.Tensor:
        del key, labels, offset, clients
        return theta

    def sketch_transform(self, key, sketches, offset) -> torch.Tensor:
        del key, offset
        return sketches

    def honest_mask(self, key, clients: int, device=None) -> torch.Tensor:
        del key
        return torch.ones((clients,), dtype=torch.bool,
                          device=resolve_device(device))

    @property
    def transforms_sketches(self) -> bool:
        """Whether the session needs this scenario's sketch hook (identity
        hooks skip it)."""
        return type(self).sketch_transform is not Scenario.sketch_transform


@dataclasses.dataclass(frozen=True)
class ComposedScenario(Scenario):
    """Hooks applied left to right over member scenarios.

    ``population`` takes the LAST member that overrides it (occupancy is
    a choice, not a transform); every other hook chains.  Member ``i``
    gets ``fold_in(key, i)``."""
    name: str = "composed"
    members: tuple = ()

    def population(self, key, clients, clusters, device=None):
        labels = Scenario.population(self, key, clients, clusters, device)
        for i, s in enumerate(self.members):
            if type(s).population is not Scenario.population:
                labels = s.population(prng.fold_in(key, i), clients,
                                      clusters, device)
        return labels

    def wave_labels(self, key, labels, offset, clients, clusters):
        for i, s in enumerate(self.members):
            labels = s.wave_labels(prng.fold_in(key, i), labels, offset,
                                   clients, clusters)
        return labels

    def corrupt_uploads(self, key, theta, labels, offset, clients):
        for i, s in enumerate(self.members):
            theta = s.corrupt_uploads(prng.fold_in(key, i), theta, labels,
                                      offset, clients)
        return theta

    def sketch_transform(self, key, sketches, offset):
        for i, s in enumerate(self.members):
            sketches = s.sketch_transform(prng.fold_in(key, i), sketches,
                                          offset)
        return sketches

    def honest_mask(self, key, clients, device=None):
        mask = Scenario.honest_mask(self, key, clients, device)
        for i, s in enumerate(self.members):
            mask &= s.honest_mask(prng.fold_in(key, i), clients, device)
        return mask

    @property
    def transforms_sketches(self) -> bool:
        return any(s.transforms_sketches for s in self.members)


# ------------------------------------------------------------- registry

_SCENARIOS: dict[str, Scenario] = {}


def register_scenario(scenario: Scenario, *, name: Optional[str] = None,
                      overwrite: bool = False) -> Scenario:
    """Register a scenario under a name.  Returns it (decorator-safe)."""
    key = name if name is not None else scenario.name
    if not key:
        raise ValueError("scenario needs a non-empty name")
    if key in _SCENARIOS and not overwrite:
        raise ValueError(f"scenario {key!r} already registered "
                         "(pass overwrite=True to replace)")
    _SCENARIOS[key] = scenario
    return scenario


def unregister_scenario(name: str) -> None:
    """Remove a registered scenario (used by tests and plugins)."""
    _SCENARIOS.pop(name, None)


def get_scenario(name) -> Scenario:
    """Resolve a name (or pass an instance through) to a scenario."""
    if not isinstance(name, str):
        return name
    try:
        return _SCENARIOS[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; "
                       f"registered: {sorted(_SCENARIOS)}") from None


def list_scenarios() -> tuple[str, ...]:
    """Names of every registered scenario."""
    return tuple(sorted(_SCENARIOS))


def build_scenario(spec, **options: Any) -> Scenario:
    """Resolve a scenario spec from command-line flags.

    ``spec`` is a registered name, a '+'-chain of names (composed left to
    right, e.g. ``"longtail+byzantine"``), a ``Scenario`` instance, or
    ``None`` (the identity).  ``options`` is one flat superset; each
    member keeps only the dataclass fields it declares."""
    if spec is None:
        spec = "none"
    if not isinstance(spec, str):
        return spec
    members = []
    for part in spec.split("+"):
        part = part.strip()
        if not part:
            continue
        s = get_scenario(part)
        if options and dataclasses.is_dataclass(s):
            fields = {f.name for f in dataclasses.fields(s) if f.init}
            kept = {k: v for k, v in options.items()
                    if k in fields and k != "name" and v is not None}
            if kept:
                s = dataclasses.replace(s, **kept)
        members.append(s)
    if not members:
        raise ValueError(f"empty scenario spec {spec!r}")
    if len(members) == 1:
        return members[0]
    return ComposedScenario(name=spec, members=tuple(members))


register_scenario(Scenario())
