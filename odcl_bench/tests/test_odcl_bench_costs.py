"""The benchmark's frozen copies equal today's originals in the program:
the kernel costs and the peaks (``roofline/``), the upload generator
(``launch/simulate.py``, ``core/erm.py``) and the recovery interval
(``core/clustering/convex.py``)."""
import numpy as np
import pytest
import torch

from odcl_bench import costs, inputs
from repro_torch.core import erm
from repro_torch.core.clustering import convex
from repro_torch.launch import simulate
from repro_torch.roofline import analysis, kernel_costs

SHAPES = [(1, 1, 1), (1048576, 8, 64), (4096, 4096, 32), (100, 10, 20)]


@pytest.mark.parametrize("m,k,d", SHAPES)
def test_kernel_costs_equal_the_programs(m, k, d):
    assert costs.pairwise_sqdist(m, k, d) == kernel_costs.pairwise_sqdist(
        m, k, d)
    assert costs.pairwise_sqdist(m, k, d, 3) == kernel_costs.pairwise_sqdist(
        m, k, d, 3)
    assert costs.kmeans_assign(m, k, d) == kernel_costs.kmeans_assign(m, k, d)
    assert costs.group_ball_proj(m, d, k) == kernel_costs.group_ball_proj(
        m, d, k)


@pytest.mark.parametrize("radius", [0.5, torch.ones(3, 1).expand(3, 7),
                                    torch.ones(3, 7)])
def test_radius_elems_equal_the_programs(radius):
    assert costs.radius_elems(radius) == kernel_costs.radius_elems(radius)


def test_peaks_equal_the_programs():
    assert costs.FP32_OPS_PER_S == analysis.HW_H100_FP32.peak_flops
    assert costs.HBM_BYTES_PER_S == analysis.HW_H100_FP32.hbm_bw


@pytest.mark.parametrize("seed", [0, 7])
def test_upload_generator_equals_the_programs(seed):
    ours = torch.Generator().manual_seed(seed)
    theirs = torch.Generator().manual_seed(seed)
    o1 = inputs.staggered_optima(ours, 8, 16)
    o2 = simulate.staggered_optima(theirs, 8, 16)
    assert torch.equal(o1, o2)
    labels = torch.arange(256) % 8
    w1 = inputs.wave_ridge_erm(ours, o1, labels, n=64)
    w2 = simulate.wave_ridge_erm(theirs, o2, labels, n=64)
    assert torch.equal(w1, w2)
    x, y = torch.randn(5, 32, 4), torch.randn(5, 32)
    assert torch.equal(inputs.batched_ridge_erm(x, y, 1e-3),
                       erm.batched_ridge_erm(x, y, 1e-3))


@pytest.mark.parametrize("seed", [0, 3])
def test_lambda_interval_equals_the_programs(seed):
    rng = np.random.default_rng(seed)
    points = rng.normal(size=(300, 5)) + 4 * (np.arange(300) % 3)[:, None]
    labels = np.arange(300) % 3
    assert inputs.lambda_interval(points, labels) == \
        convex.lambda_interval(points, labels)


def test_subseed_takes_large_seeds_and_separates_streams():
    big = 2 ** 31 + 12345
    assert inputs.subseed(big, 1) != inputs.subseed(big, 2)
    assert inputs.subseed(big, 1) != inputs.subseed(big + 1, 1)
    assert 0 <= inputs.subseed(2 ** 64 + 3, 9) < 2 ** 63
