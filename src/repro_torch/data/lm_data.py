"""Clustered synthetic LM token streams (the port's copy of
``repro/data/lm_data.py``: numpy only, the same tokens bit for bit).

For the deep-architecture integration we need per-client token data
whose distribution depends on the client's (hidden) cluster, mirroring
Assumption 1 at LM scale.  Each cluster k gets its own bigram transition
table (a random markov chain over the vocab); clients sample sequences
from their cluster's chain.  Clients in the same cluster therefore share
a population optimum, clients in different clusters do not.

Everything is generated on the fly from a seed — no disk, no downloads —
and stacked over clients (leading axis C).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ClusteredTokenStream:
    """Infinite token stream for one federation of LM clients."""
    n_clients: int
    n_clusters: int
    vocab_size: int
    seed: int = 0
    branching: int = 16     # out-degree of each markov state

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        assert self.n_clients % self.n_clusters == 0
        self.true_labels = np.repeat(
            np.arange(self.n_clusters), self.n_clients // self.n_clusters)
        # per-cluster sparse bigram tables: successors + logits
        self.succ = np.stack([
            rng.integers(0, self.vocab_size,
                         size=(self.vocab_size, self.branching))
            for _ in range(self.n_clusters)
        ])                                              # (K, V, B)
        logits = rng.normal(size=(self.n_clusters, self.vocab_size, self.branching))
        e = np.exp(logits - logits.max(-1, keepdims=True))
        self.probs = e / e.sum(-1, keepdims=True)       # (K, V, B)

    def sample(self, client: int, batch: int, seq_len: int, step: int) -> np.ndarray:
        """(batch, seq_len+1) tokens for one client at a given step."""
        k = int(self.true_labels[client])
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + client) * 1_000_003 + step)
        toks = np.empty((batch, seq_len + 1), np.int32)
        state = rng.integers(0, self.vocab_size, size=batch)
        toks[:, 0] = state
        for t in range(1, seq_len + 1):
            u = rng.uniform(size=batch)
            cdf = np.cumsum(self.probs[k][state], axis=-1)
            choice = (u[:, None] < cdf).argmax(axis=-1)
            state = self.succ[k][state, choice]
            toks[:, t] = state
        return toks


def make_lm_batch_iterator(stream: ClusteredTokenStream, *, clients_per_batch,
                           per_client_batch: int, seq_len: int):
    """Yield (tokens, labels) of shape (C, b, S) stacked over clients.

    ``tokens[c]`` comes from client ``clients_per_batch[c]``'s cluster
    distribution.
    """
    step = 0
    while True:
        toks = np.stack([
            stream.sample(c, per_client_batch, seq_len, step)
            for c in clients_per_batch
        ])                                              # (C, b, S+1)
        yield toks[:, :, :-1], toks[:, :, 1:]
        step += 1
