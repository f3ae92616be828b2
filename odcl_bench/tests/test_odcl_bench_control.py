"""The control on the card, at a size a test run holds: the plain
reference computed in TF32, put in the program's place, fails at least
one of the numbers that decide ``correct`` where the program's own
round passes them all (``control.py`` takes the readings at the cells'
own sizes)."""
import pytest
import torch

from odcl_bench import control, harness, judge

from conftest import make_root


@pytest.mark.cuda
@pytest.mark.parametrize("cell,clients", [("km-1m-round", 65536),
                                          ("cc-4k-round", 1024)])
def test_the_control_fails_where_the_program_passes(tmp_path, cell, clients):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control is read on the card")
    root = make_root(tmp_path, {"odcl-km-1m": clients, "odcl-cc-4k": clients})
    _, cfg, _ = harness.resolve(harness.load_bench(root), cell, root)
    for seed in (1, 2, 3):
        got = control.readings(cell, seed, 0.5, root=root)
        assert judge.checks(got["program"], cfg["limits"])[0], got
        assert not judge.checks(got["control"], cfg["limits"])[0], got
