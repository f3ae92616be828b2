"""Synthetic federations and the clustered LM token streams (the port's
counterpart of ``repro/data``)."""
from repro_torch.data.lm_data import (
    ClusteredTokenStream,
    make_lm_batch_iterator,
)
from repro_torch.data.synthetic import (
    Federation,
    make_linear_regression_federation,
    make_logistic_federation,
    make_mnist_like_federation,
    min_separation,
    paper_synthetic_optima,
)

__all__ = [
    "ClusteredTokenStream",
    "Federation",
    "make_linear_regression_federation",
    "make_lm_batch_iterator",
    "make_logistic_federation",
    "make_mnist_like_federation",
    "min_separation",
    "paper_synthetic_optima",
]
