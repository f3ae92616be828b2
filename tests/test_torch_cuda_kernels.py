"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs a CUDA device and skips without one; the
file imports no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest -m cuda tests/test_torch_cuda_kernels.py

Tolerances are chip_smoke.py's: distances within rtol 1e-5 and
atol 1e-4 * (||a||^2 + ||b||^2); labels equal on every row whose two
nearest distances differ by more than 1e-5 relative (the kernel's FMA
order and cuBLAS's differ in the last bits); sums within rtol 1e-5 /
atol 1e-4, counts exactly; a repeat run bit-identical.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import kmeans_assign as tassign
from repro_torch.kernels import ops
from repro_torch.kernels import pairwise_l2 as tpairwise

pytestmark = pytest.mark.cuda

SHAPES = [(1, 1, 16), (1, 8, 64), (7, 8, 64), (4097, 257, 16),
          (4096, 8, 64), (4097, 8, 200), (65536, 8, 64)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _draw(seed, device, *shapes):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(device)
            for s in shapes]


@pytest.mark.parametrize("m,k,d", SHAPES)
def test_pairwise_kernel_matches_plain(cuda_device, m, k, d):
    a, b = _draw(m + k + d, cuda_device, (m, d), (k, d))
    got = tpairwise.pairwise_sqdist(a, b)
    torch.cuda.synchronize()
    want = tpairwise.pairwise_sqdist_ref(a, b)
    scale = (a * a).sum(1)[:, None] + (b * b).sum(1)[None, :]
    excess = (got - want).abs() - (1e-5 * want.abs() + 1e-4 * scale)
    assert float(excess.max()) <= 0.0


@pytest.mark.parametrize("m,k,d", SHAPES)
def test_assign_kernel_matches_plain(cuda_device, m, k, d):
    pts, cts = _draw(3 * m + k + d, cuda_device, (m, d), (k, d))
    lab, sums, cnt = tassign.kmeans_assign(pts, cts)
    torch.cuda.synchronize()
    wl, ws, wc = tassign.kmeans_assign_ref(pts, cts)
    if k > 1:
        two = torch.topk(tpairwise.pairwise_sqdist_ref(pts, cts), 2, dim=1,
                         largest=False).values
        clear = (two[:, 1] - two[:, 0]) > 1e-5 * two[:, 1].abs()
    else:
        clear = torch.ones(m, dtype=torch.bool, device=cuda_device)
    assert torch.equal(lab[clear], wl[clear])
    if bool(clear.all()):
        torch.testing.assert_close(sums, ws, rtol=1e-5, atol=1e-4)
        assert torch.equal(cnt, wc)
    again = tassign.kmeans_assign(pts, cts)
    assert torch.equal(again[0], lab) and torch.equal(again[1], sums)
    assert torch.equal(again[2], cnt)


def test_launch_counters_count_kernel_launches(cuda_device):
    a, b = _draw(0, cuda_device, (33, 16), (4, 16))
    ops.reset_launch_counts()
    ops.pairwise_sqdist(a, b)
    ops.kmeans_assign(a, b)
    ops.kmeans_assign(a, b)
    assert ops.launch_counts() == {"pairwise_sqdist": 1, "kmeans_assign": 2}


def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    a, b = _draw(2, cuda_device, (8, 4), (3, 4))
    with pytest.raises(TypeError):
        tpairwise.pairwise_sqdist(a.double(), b.double())
    with pytest.raises(ValueError):
        tassign.kmeans_assign(a.T, b)
    with pytest.raises(ValueError, match="shared memory"):
        big = torch.zeros((1024, 64), device=cuda_device)
        tassign.kmeans_assign(big[:1], big)
