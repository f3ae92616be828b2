"""Synthetic federations (the port's counterpart of ``repro/data``; the
LM token streams come with training)."""
from repro_torch.data.synthetic import (
    Federation,
    make_linear_regression_federation,
    make_logistic_federation,
    make_mnist_like_federation,
    min_separation,
    paper_synthetic_optima,
)

__all__ = [
    "Federation",
    "make_linear_regression_federation",
    "make_logistic_federation",
    "make_mnist_like_federation",
    "min_separation",
    "paper_synthetic_optima",
]
