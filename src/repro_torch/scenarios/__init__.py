"""Adversity scenarios over the synthetic client population (the port of
``repro/scenarios``).

  * ``Scenario``: the hook protocol (population / wave_labels /
    corrupt_uploads / sketch_transform / honest_mask); the base class is
    the identity scenario ``"none"``.
  * Built-ins: ``drift`` (mid-stream distribution migration),
    ``longtail`` (Zipf occupancy), ``byzantine`` (sign-flip /
    scaled-noise / colluding sketch-spoof attackers), ``dp``
    ((epsilon, delta)-Gaussian sketch release).
  * Registry: ``register_scenario`` / ``get_scenario`` /
    ``list_scenarios`` / ``unregister_scenario``; ``build_scenario``
    resolves '+'-composed specs from one flat option set.

Wired through ``data/synthetic.py``, ``launch/simulate.py``
(``--scenario``) and the session's ``sketch_transform=`` hook.
"""
from repro_torch.scenarios.api import (
    ComposedScenario,
    Scenario,
    ScenarioLike,
    build_scenario,
    get_scenario,
    list_scenarios,
    register_scenario,
    unregister_scenario,
)
from repro_torch.scenarios.library import (
    ByzantineScenario,
    DPScenario,
    DriftScenario,
    LongtailScenario,
)

__all__ = [
    "ByzantineScenario",
    "ComposedScenario",
    "DPScenario",
    "DriftScenario",
    "LongtailScenario",
    "Scenario",
    "ScenarioLike",
    "build_scenario",
    "get_scenario",
    "list_scenarios",
    "register_scenario",
    "unregister_scenario",
]
