"""The port's clustered LM token streams against the reference's: the
same seed gives the same tokens, bit for bit (both are numpy), through
``sample``, ``make_lm_batch_iterator`` and ``make_eval_batch``."""
import numpy as np
import pytest

from repro.data import ClusteredTokenStream as JStream
from repro.data import make_lm_batch_iterator as jbatches
from repro.launch.steps import make_eval_batch as jeval_batch
from repro_torch import runtime
from repro_torch.data import ClusteredTokenStream, make_lm_batch_iterator
from repro_torch.launch.steps import make_eval_batch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One host thread: the tensors here are small, and parallel test
    workers must not oversubscribe the CPU."""
    with runtime.pinned_threads(1):
        yield


@pytest.mark.parametrize("clients,clusters,vocab,seed,branching",
                         [(4, 2, 64, 0, 4), (8, 2, 256, 3, 16),
                          (6, 3, 1000, 7, 16)])
def test_stream_tables_and_samples_are_bit_equal(clients, clusters, vocab,
                                                 seed, branching):
    kw = dict(n_clients=clients, n_clusters=clusters, vocab_size=vocab,
              seed=seed, branching=branching)
    got, want = ClusteredTokenStream(**kw), JStream(**kw)
    np.testing.assert_array_equal(got.true_labels, want.true_labels)
    np.testing.assert_array_equal(got.succ, want.succ)
    np.testing.assert_array_equal(got.probs, want.probs)
    for c in range(clients):
        for step in (0, 5):
            np.testing.assert_array_equal(got.sample(c, 3, 17, step),
                                          want.sample(c, 3, 17, step))


def test_batch_iterator_and_eval_batch_are_bit_equal():
    kw = dict(n_clients=4, n_clusters=2, vocab_size=64, seed=1, branching=4)
    got_s, want_s = ClusteredTokenStream(**kw), JStream(**kw)
    got = make_lm_batch_iterator(got_s, clients_per_batch=[0, 1, 2, 3],
                                 per_client_batch=2, seq_len=16)
    want = jbatches(want_s, clients_per_batch=[0, 1, 2, 3],
                    per_client_batch=2, seq_len=16)
    for _ in range(3):
        (gt, gl), (wt, wl) = next(got), next(want)
        assert gt.shape == (4, 2, 16) and gt.dtype == np.int32
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gl, wl)
    ge = make_eval_batch(got_s, n_clients=4, batch=2, seq_len=16)
    we = jeval_batch(want_s, n_clients=4, batch=2, seq_len=16)
    for key in ("tokens", "labels"):
        np.testing.assert_array_equal(ge[key], we[key])


def test_stream_rejects_uneven_clusters():
    with pytest.raises(AssertionError):
        ClusteredTokenStream(n_clients=5, n_clusters=2, vocab_size=8)
