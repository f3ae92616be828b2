"""The port's recurrent blocks (``repro_torch/models/recurrent.py``)
against the reference's, function by function, on the same numpy inputs
(fp32).

Tolerances: within 1e-5 of the output's largest magnitude (the chunked
mLSTM, the sLSTM loop, the decode steps and the conv run the reference's
arithmetic in other summation orders).  The selective scan's doubling
scan adds in another order than ``jax.lax.associative_scan``: within
2e-5 of the largest magnitude (about 100 fp32 ulps), on the single-chunk
path (s <= chunk) and the chunked one (``ssm_chunk`` 16 at s = 64), with
and without an incoming state.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import recurrent as jrec
from repro_torch import runtime
from repro_torch.models import recurrent as trec


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One host thread: the tensors here are small, and parallel test
    workers must not oversubscribe the CPU."""
    with runtime.pinned_threads(1):
        yield


def _close(got, want, rel=1e-5):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), (err, rel)


def _draw(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(scale * rng.normal(size=s)).astype(np.float32) for s in shapes]


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


# s = 32: one chunk (chunk 32 and 64) and four chunks of 8; with and
# without an incoming state
@pytest.mark.parametrize("chunk,with_state", [(32, False), (64, False),
                                              (8, False), (8, True)])
def test_mlstm_chunkwise_matches(chunk, with_state):
    b, h, s, dh = 2, 3, 32, 16
    q, k, v, ig, fg = _draw(chunk, (b, h, s, dh), (b, h, s, dh),
                            (b, h, s, dh), (b, h, s), (b, h, s))
    c0, n0 = _draw(7, (b, h, dh, dh), (b, h, dh))
    (jq, jk, jv, jig, jfg, jc0, jn0), (tq, tk, tv, tig, tfg, tc0, tn0) = \
        _both(q, k, v, 2.0 * ig, fg + 2.0, c0, n0)
    jstate = jrec.MLSTMState(c=jc0, n=jn0) if with_state else None
    tstate = trec.MLSTMState(c=tc0, n=tn0) if with_state else None
    jo, js = jrec.mlstm_chunkwise(jq, jk, jv, jig, jfg, chunk=chunk,
                                  state=jstate)
    to, ts = trec.mlstm_chunkwise(tq, tk, tv, tig, tfg, chunk=chunk,
                                  state=tstate)
    _close(to, jo)
    _close(ts.c, js.c)
    _close(ts.n, js.n)


def test_mlstm_chunk_must_divide_the_sequence():
    x = torch.zeros((1, 1, 12, 4))
    g = torch.zeros((1, 1, 12))
    with pytest.raises(ValueError, match="divisible"):
        trec.mlstm_chunkwise(x, x, x, g, g, chunk=8)


def test_mlstm_decode_step_matches():
    b, h, dh = 2, 3, 16
    q, k, v, ig, fg, c0, n0 = _draw(3, (b, h, dh), (b, h, dh), (b, h, dh),
                                    (b, h), (b, h), (b, h, dh, dh), (b, h, dh))
    j, t = _both(q, k, v, ig, fg, c0, n0)
    jo, js = jrec.mlstm_decode_step(*j[:5], jrec.MLSTMState(c=j[5], n=j[6]))
    to, ts = trec.mlstm_decode_step(*t[:5], trec.MLSTMState(c=t[5], n=t[6]))
    _close(to, jo)
    _close(ts.c, js.c)
    _close(ts.n, js.n)


@pytest.mark.parametrize("with_state", [False, True])
def test_slstm_scan_matches(with_state):
    b, s, d = 2, 24, 40
    z, ig, fg, og, c0, n0 = _draw(4, (b, s, d), (b, s, d), (b, s, d),
                                  (b, s, d), (b, d), (b, d))
    j, t = _both(z, ig, fg, og, c0, n0)
    jst = jrec.SLSTMState(c=j[4], n=j[5]) if with_state else None
    tst = trec.SLSTMState(c=t[4], n=t[5]) if with_state else None
    jh, js = jrec.slstm_scan(*j[:4], state=jst)
    th, ts = trec.slstm_scan(*t[:4], state=tst)
    _close(th, jh)
    _close(ts.c, js.c)
    _close(ts.n, js.n)


def test_slstm_decode_step_matches():
    b, d = 3, 40
    z, ig, fg, og, c0, n0 = _draw(5, *[(b, d)] * 6)
    j, t = _both(z, ig, fg, og, c0, n0)
    jh, js = jrec.slstm_decode_step(*j[:4], jrec.SLSTMState(c=j[4], n=j[5]))
    th, ts = trec.slstm_decode_step(*t[:4], trec.SLSTMState(c=t[4], n=t[5]))
    _close(th, jh)
    _close(ts.c, js.c)
    _close(ts.n, js.n)


def _ssm_inputs(seed, b, s, di, n):
    x, dt, bm, cm, h0 = _draw(seed, (b, s, di), (b, s, di), (b, s, n),
                              (b, s, n), (b, di, n))
    a_log = np.log(np.tile(np.arange(1, n + 1, dtype=np.float32), (di, 1)))
    d_skip = np.linspace(0.5, 1.5, di).astype(np.float32)
    return x, dt - 1.0, bm, cm, a_log, d_skip, h0


# s = 64 with ssm_chunk 16: four chunks in turn; chunk 0 and chunk 64
# (s <= chunk): one scan over the whole length; s = 48 with chunk 32
# (not a multiple): one scan too, as in the reference
@pytest.mark.parametrize("s,chunk", [(64, 16), (64, 0), (64, 64), (48, 32)])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssm_scan_matches(s, chunk, with_state):
    x, dt, bm, cm, a_log, d_skip, h0 = _ssm_inputs(s + chunk, 2, s, 24, 8)
    j, t = _both(x, dt, bm, cm, a_log, d_skip, h0)
    jy, jh = jrec.ssm_scan(*j[:6], state_h=j[6] if with_state else None,
                           chunk=chunk)
    ty, th = trec.ssm_scan(*t[:6], state_h=t[6] if with_state else None,
                           chunk=chunk)
    _close(ty, jy, 2e-5)
    _close(th, jh, 2e-5)


@pytest.mark.parametrize("s", [1, 2, 5, 16, 33])
def test_linear_scan_is_the_sequential_recurrence(s):
    rng = np.random.default_rng(s)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, s, 3)).astype(np.float32))
    u = torch.from_numpy(rng.normal(size=(2, s, 3)).astype(np.float32))
    h = torch.zeros((2, 3))
    want = []
    for t in range(s):
        h = a[:, t] * h + u[:, t]
        want.append(h)
    _close(trec.linear_scan(a, u), torch.stack(want, dim=1).numpy())


def test_ssm_decode_step_matches():
    x, dt, bm, cm, a_log, d_skip, h0 = _ssm_inputs(9, 3, 1, 24, 8)
    j, t = _both(x[:, 0], dt[:, 0], bm[:, 0], cm[:, 0], a_log, d_skip, h0)
    jy, jh = jrec.ssm_decode_step(*j)
    ty, th = trec.ssm_decode_step(*t)
    _close(ty, jy)
    _close(th, jh)


@pytest.mark.parametrize("s,with_state", [(9, False), (9, True), (1, True)])
def test_causal_conv1d_matches(s, with_state):
    x, w, st = _draw(s, (2, s, 24), (4, 24), (2, 3, 24))
    j, t = _both(x, w, st)
    jy, js = jrec.causal_conv1d(j[0], j[1],
                                state=j[2] if with_state else None)
    ty, ts = trec.causal_conv1d(t[0], t[1],
                                state=t[2] if with_state else None)
    _close(ty, jy)
    _close(ts, js)


def test_conv_state_stays_in_the_model_dtype():
    x = torch.ones((1, 3, 8), dtype=torch.bfloat16)
    w = torch.ones((4, 8), dtype=torch.bfloat16)
    y, state = trec.causal_conv1d(x, w)
    assert y.dtype == state.dtype == torch.bfloat16
    assert state.shape == (1, 3, 8)
