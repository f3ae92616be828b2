"""The port's serve and train CLIs on the new families, on the CPU:
``--reduced`` deepseek-moe-16b (4 experts, two shared), xlstm-125m (one
mLSTM + sLSTM pair) and hymba-1.5b (attention + SSM), vocab 256.

Serve: greedy tokens in range and the CLI's three lines; the same
greedy run repeats token for token.  Train: one ODCL run of 4 clients
in 2 clusters (device engine, the router-invariant sketch for the MoE),
finite losses, K' clusters and a stacked checkpoint that the serve
CLI reads back as client 1's model.  pixtral-12b (patch inputs) and
hubert-xlarge (encoder-only) are refused by the serve CLI.
"""
import pytest
import torch

from repro_torch import runtime
from repro_torch.checkpoint import latest_step
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain

ARCHS = ["deepseek-moe-16b", "xlstm-125m", "hymba-1.5b"]
SERVE = ["--reduced", "--batch", "2", "--prompt-len", "8", "--gen", "4",
         "--device", "cpu"]
TRAIN = ["--reduced", "--clients", "4", "--clusters", "2", "--batch", "1",
         "--seq-len", "8", "--sketch-dim", "16", "--local-steps", "2",
         "--post-steps", "1", "--engine", "device", "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One host thread: the tensors here are small, and parallel test
    workers must not oversubscribe the CPU."""
    with runtime.pinned_threads(1):
        yield


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_runs_on_the_cpu(arch, capsys):
    tokens = tserve.main(["--arch", arch] + SERVE)
    assert tokens.shape == (2, 12) and tokens.device.type == "cpu"
    assert int(tokens.min()) >= 0 and int(tokens.max()) < 256
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("arch=" + arch + " batch=2 prompt=8 gen=4")
    assert "tok/s" in out[1]
    assert torch.equal(tserve.main(["--arch", arch] + SERVE), tokens)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_then_serve_a_client(arch, tmp_path, capsys):
    state, labels = ttrain.main(["--arch", arch, "--ckpt-dir",
                                 str(tmp_path)] + TRAIN)
    assert latest_step(str(tmp_path)) == state.step == 3
    assert set(labels.tolist()) <= {0, 1} and len(labels) == 4
    out = capsys.readouterr().out
    assert "[odcl]" in out and "nan" not in out.lower()
    tokens = tserve.main(["--arch", arch, "--ckpt-dir", str(tmp_path),
                          "--client", "1"] + SERVE)
    assert "[ckpt] restored step 3 (client 1)" in capsys.readouterr().out
    assert tokens.shape == (2, 12)


@pytest.mark.parametrize("arch,match", [("pixtral-12b", "patch"),
                                        ("hubert-xlarge", "encoder-only")])
def test_serve_refuses_what_it_cannot_feed(arch, match):
    with pytest.raises(SystemExit, match=match):
        tserve.main(["--arch", arch] + SERVE)


def test_generate_refuses_patch_inputs():
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    cfg = get_config("pixtral-12b").reduced(max_d_model=64, max_vocab=64)
    model = init_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="multimodal"):
        tserve.generate(model, cfg, torch.zeros((1, 4), dtype=torch.long),
                        2, device="cpu")
