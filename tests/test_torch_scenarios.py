"""The port's adversity scenarios against the reference's, on the CPU.

The counterparts of ``tests/test_scenarios.py``: registry, composition,
frozen and hashable instances, identity hooks, and the wave-partition
invariance of the port's own keyed draws (``utils/prng.py``).  Then each
hook with the reference's draws carried across
(``interop.draws_from_numpy``: the reference's Bernoulli masks and its
Gaussian blocks, drawn with the reference's keys and role tags): masks
and sign flips exact, noised floats within rtol 1e-6 (atol 1e-6 of the
row scale); longtail occupancy exact; the session's sketch hook
against the reference session's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import AggregationSession as JSession
from repro.scenarios import build_scenario as jbuild
from repro.scenarios import library as jlib
from repro_torch import runtime
from repro_torch.core.engine.session import AggregationSession
from repro_torch.interop import draws_from_numpy, projection_from_numpy
from repro_torch.scenarios import (
    ByzantineScenario,
    ComposedScenario,
    DPScenario,
    DriftScenario,
    LongtailScenario,
    Scenario,
    build_scenario,
    get_scenario,
    list_scenarios,
    register_scenario,
    unregister_scenario,
)
from repro_torch.scenarios import library as tlib
from repro_torch.utils import prng

from test_torch_sketch import ref_projection


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One host thread: the tensors here are small, and parallel test
    workers must not oversubscribe the CPU."""
    with runtime.pinned_threads(1):
        yield


CPU = "cpu"


def ref_mask(key, tag, n, frac):
    """The reference's Bernoulli coin of every client index under a tag."""
    return np.asarray(jlib._mask_by_index(jax.random.fold_in(key, tag),
                                          jnp.arange(n), frac))


def ref_normal(key, tag, shape, offset=None):
    """The reference's Gaussian block under a tag (and a wave offset)."""
    k = jax.random.fold_in(key, tag)
    if offset is not None:
        k = jax.random.fold_in(k, offset)
    return np.asarray(jax.random.normal(k, shape, jnp.float32))


def assert_close(got, want, rtol=1e-6):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    scale = float(np.abs(want).max()) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


# ------------------------------------------------------------------ registry

def test_registry_round_trip():
    assert set(list_scenarios()) == {"none", "drift", "longtail",
                                     "byzantine", "dp"}
    probe = ByzantineScenario(name="probe-scen", frac=0.3)
    register_scenario(probe)
    try:
        assert get_scenario("probe-scen") is probe
        with pytest.raises(ValueError, match="already registered"):
            register_scenario(ByzantineScenario(name="probe-scen"))
    finally:
        unregister_scenario("probe-scen")
    with pytest.raises(KeyError, match="unknown scenario"):
        get_scenario("probe-scen")


def test_build_scenario_specializes_and_composes():
    s = build_scenario("byzantine", frac=0.25, attack="noise", epsilon=4.0)
    assert isinstance(s, ByzantineScenario)
    assert (s.frac, s.attack) == (0.25, "noise")   # epsilon ignored
    assert build_scenario(None).name == "none"
    inst = DPScenario(epsilon=2.0)
    assert build_scenario(inst) is inst
    comp = build_scenario("longtail+byzantine+dp", frac=0.2, epsilon=8.0,
                          zipf_a=1.5)
    ref = jbuild("longtail+byzantine+dp", frac=0.2, epsilon=8.0, zipf_a=1.5)
    assert isinstance(comp, ComposedScenario)
    lt, byz, dp = comp.members
    assert isinstance(lt, LongtailScenario) and lt.zipf_a == 1.5
    assert isinstance(byz, ByzantineScenario) and byz.frac == 0.2
    assert isinstance(dp, DPScenario) and dp.epsilon == 8.0
    for mine, theirs in zip(comp.members, ref.members):
        assert ({f.name: getattr(mine, f.name)
                 for f in dataclasses.fields(theirs)}
                == dataclasses.asdict(theirs))
    assert comp.name == ref.name
    assert comp.transforms_sketches == ref.transforms_sketches
    mask = comp.honest_mask(prng.key(0), 64, device=CPU)
    assert mask.dtype == torch.bool and not bool(mask.all())
    with pytest.raises(ValueError, match="empty"):
        build_scenario("+")


def test_scenarios_are_frozen_and_hashable():
    replay = draws_from_numpy(masks={tlib._TAG_ROLE: np.zeros(4, bool)})
    for s in (Scenario(), DriftScenario(), LongtailScenario(),
              ByzantineScenario(), DPScenario(),
              ComposedScenario(members=(DriftScenario(), DPScenario()))):
        assert dataclasses.is_dataclass(s)
        assert hash(s) == hash(dataclasses.replace(s))
        # carried draws do not change what a scenario is
        assert dataclasses.replace(s, draws=replay) == s
        with pytest.raises(dataclasses.FrozenInstanceError):
            s.name = "x"


def test_role_tags_are_the_reference_tags():
    for tag in ("_TAG_ROLE", "_TAG_NOISE", "_TAG_SPOOF", "_TAG_DRIFT",
                "_TAG_DP"):
        assert getattr(tlib, tag) == getattr(jlib, tag)


def test_identity_scenario_hooks_are_noops():
    key = prng.key(0)
    s = build_scenario(None)
    labels = s.population(key, 12, 4, device=CPU)
    np.testing.assert_array_equal(labels.numpy(), np.arange(12) % 4)
    theta = torch.ones((6, 3))
    assert s.corrupt_uploads(key, theta, labels[:6], 0, 12) is theta
    assert s.sketch_transform(key, theta, 0) is theta
    assert s.wave_labels(key, labels, 0, 12, 4) is labels
    assert not s.transforms_sketches
    assert bool(s.honest_mask(key, 12, device=CPU).all())


# ------------------------------------------- the port's own keyed draws

@pytest.mark.parametrize("cuts", [(24,), (1, 40), (7, 8, 9, 10)])
def test_byzantine_wave_partition_invariance(cuts):
    """Corrupting the population in one call == wave by wave: the role
    coin is keyed by the GLOBAL client index."""
    key = prng.key(7)
    s = ByzantineScenario(frac=0.3)
    theta = torch.from_numpy(
        np.random.default_rng(1).normal(size=(64, 5)).astype(np.float32))
    full = s.corrupt_uploads(key, theta, None, 0, 64)
    edges = (0,) + cuts + (64,)
    waved = torch.cat([s.corrupt_uploads(key, theta[a:b], None, a, 64)
                       for a, b in zip(edges[:-1], edges[1:])])
    assert torch.equal(full, waved)
    mask = s.honest_mask(key, 64, device=CPU).numpy()
    flipped = ~np.all(full.numpy() == theta.numpy(), axis=1)
    np.testing.assert_array_equal(~mask, flipped)
    assert 0.0 < flipped.mean() < 0.6


@pytest.mark.parametrize("cuts", [(32,), (5, 50)])
def test_drift_wave_partition_invariance(cuts):
    key = prng.key(2)
    s = DriftScenario(drift_frac=0.5, drift_at=0.25)
    labels = torch.arange(64) % 4
    full = s.wave_labels(key, labels, 0, 64, 4)
    edges = (0,) + cuts + (64,)
    waved = torch.cat([s.wave_labels(key, labels[a:b], a, 64, 4)
                       for a, b in zip(edges[:-1], edges[1:])])
    assert torch.equal(full, waved)
    moved = (full != labels).numpy()
    assert not moved[:16].any() and moved[16:].any()


def test_keyed_draws_are_wave_partition_invariant():
    key = prng.fold_in(prng.key(3), 11)
    idx = torch.arange(5000)
    whole = prng.bernoulli(key, idx, 0.3)
    parts = torch.cat([prng.bernoulli(key, idx[a:a + 700], 0.3)
                       for a in range(0, 5000, 700)])
    assert torch.equal(whole, parts)
    assert abs(float(whole.float().mean()) - 0.3) < 0.03
    z = prng.normal(key, (200, 50), device=CPU)
    assert torch.equal(z, prng.normal(key, (200, 50), device=CPU))
    assert abs(float(z.mean())) < 0.02 and abs(float(z.std()) - 1) < 0.02
    u = prng.uniform(key, idx)
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    # an int and a tensor of one element fold to the same key
    assert prng.fold_in(key, 5) == int(prng.fold_in(key, torch.tensor([5]))[0])
    with pytest.raises(ValueError):
        prng.fold_in(key, -1)


def test_byzantine_spoof_forges_sketch_channel_only():
    key = prng.key(3)
    s = ByzantineScenario(frac=0.4, attack="spoof")
    assert s.transforms_sketches
    theta = torch.ones((32, 5))
    assert s.corrupt_uploads(key, theta, None, 0, 32) is theta
    sk = torch.randn((32, 8), generator=torch.Generator().manual_seed(0))
    out = s.sketch_transform(key, sk, 0).numpy()
    bad = ~s.honest_mask(key, 32, device=CPU).numpy()
    assert bad.any()
    assert np.ptp(out[bad], axis=0).max() == 0.0
    np.testing.assert_array_equal(out[~bad], sk.numpy()[~bad])
    with pytest.raises(ValueError, match="unknown byzantine attack"):
        ByzantineScenario(attack="bogus").corrupt_uploads(key, theta, None,
                                                          0, 32)


def test_dp_sketch_transform_clips_then_noises():
    key = prng.key(5)
    sk = 50.0 * torch.randn((128, 16),
                            generator=torch.Generator().manual_seed(5))
    out = DPScenario(epsilon=1e9, clip=1.0).sketch_transform(key, sk,
                                                             0).numpy()
    norms = np.linalg.norm(out, axis=1)
    assert np.all(norms <= 1.0 + 1e-4)
    cos = np.sum(out * sk.numpy(), axis=1) / np.maximum(
        norms * np.linalg.norm(sk.numpy(), axis=1), 1e-12)
    assert np.all(cos > 1.0 - 1e-5)

    def spread(eps):
        return float(DPScenario(epsilon=eps, clip=1.0).sketch_transform(
            key, torch.zeros((128, 16)), 0).std())

    assert spread(1.0) > 4.0 * spread(16.0)
    dp = DPScenario(epsilon=2.0, delta=1e-5, clip=3.0)
    assert dp.sigma == pytest.approx(
        float(3.0 * jnp.sqrt(2.0 * jnp.log(1.25 / 1e-5)) / 2.0), rel=1e-6)


def test_drift_shifts_only_late_stream_clients():
    key = prng.key(2)
    s = DriftScenario(drift_frac=1.0, drift_at=0.5, shift=2)
    labels = torch.arange(64) % 4
    out = s.wave_labels(key, labels, 0, 64, 4).numpy()
    np.testing.assert_array_equal(out[:32], labels.numpy()[:32])
    np.testing.assert_array_equal(out[32:], (labels.numpy()[32:] + 2) % 4)


@pytest.mark.parametrize("clients,clusters,a", [
    (100, 8, 1.2), (1000, 10, 0.5), (9, 8, 2.0), (4096, 8, 1.2),
    (1_048_576, 8, 1.2), (77, 3, 3.0)])
def test_longtail_occupancy_equals_reference(clients, clusters, a):
    want = np.asarray(jlib.LongtailScenario(zipf_a=a).population(
        jax.random.PRNGKey(0), clients, clusters))
    got = LongtailScenario(zipf_a=a).population(prng.key(0), clients,
                                                clusters, device=CPU)
    np.testing.assert_array_equal(got.numpy(), want)
    counts = np.bincount(want, minlength=clusters)
    assert counts.min() >= 1 and np.all(np.diff(counts) <= 0)
    with pytest.raises(ValueError, match="clients >= clusters"):
        LongtailScenario().population(prng.key(0), 4, 8, device=CPU)


# ------------------------------------ the reference's draws carried across

@pytest.mark.parametrize("attack", ["sign_flip", "noise", "spoof"])
def test_byzantine_hooks_match_reference(attack):
    key = jax.random.PRNGKey(11)
    C, d, s, frac, scale = 96, 5, 8, 0.3, 4.0
    rng = np.random.default_rng(2)
    theta = rng.normal(size=(C, d)).astype(np.float32)
    sk = rng.normal(size=(C, s)).astype(np.float32)
    ref = jlib.ByzantineScenario(frac=frac, attack=attack, scale=scale)
    edges = [0, 40, 96]
    draws = draws_from_numpy(
        masks={tlib._TAG_ROLE: ref_mask(key, jlib._TAG_ROLE, C, frac)},
        normals={tlib._TAG_SPOOF: ref_normal(key, jlib._TAG_SPOOF, (s,)),
                 **{(tlib._TAG_NOISE, a): ref_normal(
                     key, jlib._TAG_NOISE, (b - a, d), a)
                    for a, b in zip(edges[:-1], edges[1:])}})
    port = ByzantineScenario(frac=frac, attack=attack, scale=scale,
                             draws=draws)
    np.testing.assert_array_equal(
        port.honest_mask(None, C, device=CPU).numpy(),
        np.asarray(ref.honest_mask(key, C)))
    assert port.transforms_sketches == ref.transforms_sketches
    for a, b in zip(edges[:-1], edges[1:]):
        want = np.asarray(ref.corrupt_uploads(key, jnp.asarray(theta[a:b]),
                                              None, a, C))
        got = port.corrupt_uploads(None, torch.from_numpy(theta[a:b]), None,
                                   a, C)
        if attack == "noise":
            assert_close(got, want)
        else:
            np.testing.assert_array_equal(got.numpy(), want)
        want = np.asarray(ref.sketch_transform(key, jnp.asarray(sk[a:b]), a))
        got = port.sketch_transform(None, torch.from_numpy(sk[a:b]), a)
        assert_close(got, want)


def test_drift_matches_reference():
    key = jax.random.PRNGKey(4)
    C, K = 200, 5
    ref = jlib.DriftScenario(drift_frac=0.6, drift_at=0.3, shift=2)
    port = DriftScenario(drift_frac=0.6, drift_at=0.3, shift=2,
                         draws=draws_from_numpy(masks={
                             tlib._TAG_DRIFT: ref_mask(key, jlib._TAG_DRIFT,
                                                       C, 0.6)}))
    labels = np.arange(C) % K
    for a, b in [(0, 70), (70, 200)]:
        want = np.asarray(ref.wave_labels(key, jnp.asarray(labels[a:b]), a,
                                          C, K))
        got = port.wave_labels(None, torch.from_numpy(labels[a:b]), a, C, K)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("eps,clip", [(1.0, 1.0), (64.0, 1.0), (8.0, 5.0)])
def test_dp_matches_reference(eps, clip):
    key = jax.random.PRNGKey(9)
    rng = np.random.default_rng(3)
    sk = (3.0 * rng.normal(size=(50, 16))).astype(np.float32)
    ref = jlib.DPScenario(epsilon=eps, clip=clip)
    port = DPScenario(epsilon=eps, clip=clip, draws=draws_from_numpy(
        normals={(tlib._TAG_DP, 7): ref_normal(key, jlib._TAG_DP, (50, 16),
                                               7)}))
    want = np.asarray(ref.sketch_transform(key, jnp.asarray(sk), 7))
    assert_close(port.sketch_transform(None, torch.from_numpy(sk), 7), want)


def test_composed_population_and_mask_match_reference():
    key = jax.random.PRNGKey(1)
    C, K = 120, 6
    ref = jbuild("longtail+byzantine", zipf_a=1.4, frac=0.2)
    # member 1 of the composition draws under fold_in(key, 1)
    byz = ByzantineScenario(frac=0.2, draws=draws_from_numpy(masks={
        tlib._TAG_ROLE: ref_mask(jax.random.fold_in(key, 1),
                                 jlib._TAG_ROLE, C, 0.2)}))
    port = ComposedScenario(name="longtail+byzantine",
                            members=(LongtailScenario(zipf_a=1.4), byz))
    np.testing.assert_array_equal(
        port.population(prng.key(1), C, K, device=CPU).numpy(),
        np.asarray(ref.population(key, C, K)))
    np.testing.assert_array_equal(
        port.honest_mask(prng.key(1), C, device=CPU).numpy(),
        np.asarray(ref.honest_mask(key, C)))


@pytest.mark.parametrize("attack", ["spoof", "dp"])
def test_session_sketch_hook_matches_reference(attack):
    """The session hands its hook the wave's first target row, on both
    packages: the same rows after ingest (rtol 1e-6 of the row scale)."""
    key = jax.random.PRNGKey(5)
    C, d, s = 60, 6, 8
    pts = np.random.default_rng(4).normal(size=(C, d)).astype(np.float32)
    waves = [(0, 25), (25, 60)]
    if attack == "spoof":
        ref = jlib.ByzantineScenario(frac=0.3, attack="spoof")
        port = ByzantineScenario(frac=0.3, attack="spoof",
                                 draws=draws_from_numpy(
                                     masks={tlib._TAG_ROLE: ref_mask(
                                         key, jlib._TAG_ROLE, C, 0.3)},
                                     normals={tlib._TAG_SPOOF: ref_normal(
                                         key, jlib._TAG_SPOOF, (s,))}))
    else:
        ref = jlib.DPScenario(epsilon=16.0, clip=2.0)
        port = DPScenario(epsilon=16.0, clip=2.0, draws=draws_from_numpy(
            normals={(tlib._TAG_DP, a): ref_normal(key, jlib._TAG_DP,
                                                   (b - a, s), a)
                     for a, b in waves}))
    jsess = JSession(C, sketch_dim=s, seed=0, sketch_transform=lambda sk, o:
                     ref.sketch_transform(key, sk, o))
    tsess = AggregationSession(
        C, sketch_dim=s, device=CPU,
        projection=projection_from_numpy(ref_projection(0, d, s), CPU),
        sketch_transform=lambda sk, o: port.sketch_transform(None, sk, o))
    for a, b in waves:
        jsess.ingest({"theta": jnp.asarray(pts[a:b])})
        tsess.ingest({"theta": torch.from_numpy(pts[a:b])})
    assert_close(tsess.sketches, np.asarray(jsess.sketches))
    # the parameters are never touched by the sketch hook
    np.testing.assert_array_equal(tsess.state().params["theta"].numpy(), pts)


def test_session_hook_sees_row_base_plus_first_row():
    seen = []
    sess = AggregationSession(10, sketch_dim=4, device=CPU, row_base=100,
                              sketch_transform=lambda sk, o: seen.append(
                                  (o, sk.shape[0])) or sk)
    sess.ingest(sketches=torch.zeros((3, 4)))
    sess.ingest(sketches=torch.zeros((4, 4)))
    sess.ingest(sketches=torch.zeros((2, 4)), client_ids=["a", "b"])
    assert seen == [(100, 3), (103, 4), (107, 2)]
