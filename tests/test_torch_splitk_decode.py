"""Split-K decode in the port (``splitk_decode``: the ring write as the
reference's elementwise select, so a length-sharded cache traces) against
the port's baseline decode and the reference's forward, teacher-forced,
on the reduced GQA configs of ``tests/test_splitk_decode.py`` with the
reference's weights carried across (``interop.model_from_numpy``).

Tolerance: the reference test's 1e-3 of max |logit| against the full
forward; split-K and baseline decode in the port within 1e-6 of it (the
same arithmetic, the ring written by another op).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import forward, init_params
from repro_torch import runtime
from repro_torch.configs import get_config as tget_config
from repro_torch.interop import model_from_numpy
from repro_torch.models import decode_step, init_decode_cache


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One host thread: the tensors here are small, and parallel test
    workers must not oversubscribe the CPU."""
    with runtime.pinned_threads(1):
        yield


def _decode(model, cfg, toks):
    cache = init_decode_cache(cfg, toks.shape[0], toks.shape[1],
                              device="cpu")
    outs = []
    with torch.no_grad():
        for t in range(toks.shape[1]):
            lg, cache = decode_step(model, cfg, cache, toks[:, t:t + 1])
            outs.append(lg[:, 0])
    return torch.stack(outs, 1).numpy(), cache


# the reference test's fast GQA case (its qwen2 and gemma cases run
# under -m slow there)
@pytest.mark.parametrize("arch", ["yi_9b"])
def test_splitk_matches_baseline_and_reference(arch):
    cfg = dataclasses.replace(get_config(arch).reduced(), serve_window=None)
    tcfg = dataclasses.replace(tget_config(arch).reduced(),
                               serve_window=None)
    params = init_params(jax.random.PRNGKey(0), cfg)
    b, s = 2, 10
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (b, s), 0,
                                         cfg.vocab_size))
    full = np.asarray(forward(params, cfg, {"tokens": toks,
                                            "labels": toks})[0])
    model = model_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                             tcfg, "cpu")
    ttoks = torch.from_numpy(toks).long()
    got = {}
    for sk in (False, True):
        got[sk], cache = _decode(model, dataclasses.replace(
            tcfg, splitk_decode=sk), ttoks)
        err = float(np.abs(got[sk] - full).max())
        assert err < 1e-3 * float(np.abs(full).max()), (sk, err)
        assert cache.pos == s
    assert float(np.abs(got[True] - got[False]).max()) <= \
        1e-6 * float(np.abs(full).max())
