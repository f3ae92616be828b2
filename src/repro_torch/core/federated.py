"""The federation's stacked state and its accounting (the port's
counterparts of ``FederatedState`` in ``repro/core/federated.py`` and of
``cluster_agreement`` / the comm-bytes rule in
``repro/core/federated_methods.py``)."""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from repro_torch.utils import tree_leaves


class FederatedState(NamedTuple):
    params: dict                 # every leaf has leading client axis C
    opt_state: Optional[dict]    # None until the LM stack is ported
    n_clients: int
    step: int = 0


def params_bytes_per_client(state: FederatedState) -> int:
    """Bytes of ONE client's model (the unit of comm accounting)."""
    c = max(1, state.n_clients)
    return sum(l.numel() // c * l.element_size()
               for l in tree_leaves(state.params))


def sketch_round_bytes(n_clients: int, sketch_dim: int,
                       bytes_per: int) -> float:
    """Protocol bytes of one sketch-clustered round: uplink = the sketch
    plus the full model, downlink = the cluster model."""
    return float(n_clients * (sketch_dim * 4 + 2 * bytes_per))


def cluster_agreement(pred, true) -> float:
    """Purity of ``pred`` against the hidden clustering ``true`` (integer
    ids): each predicted cluster votes for its majority truth."""
    pred, true = np.asarray(pred), np.asarray(true)
    total = 0
    for c in np.unique(pred):
        total += int(np.bincount(true[pred == c]).max())
    return total / len(true)
