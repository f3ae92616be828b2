"""The port's serving driver against the reference's, on the reduced
qwen2-0.5b (float32) with the reference's weights carried across.

Greedy tokens must be equal up to the first position whose top-2 logit
margin lies within the logit tolerance (1e-4 of the largest magnitude,
as in ``test_torch_models.py``); past such a near-tie the two sequences
may part, and the rest of that row is not compared.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.launch import serve as jserve
from repro.models import transformer as jtf
from repro_torch import runtime
from repro_torch.configs import get_config as tget_config
from repro_torch.interop import model_from_numpy
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as ttf
from repro_torch.models.planted import (
    continuation, plant_previous_token_head)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One host thread: the tensors here are small, and parallel test
    workers must not oversubscribe the CPU."""
    with runtime.pinned_threads(1):
        yield


ARCH = "qwen2-0.5b"


@pytest.fixture(scope="module")
def models():
    cfg = get_config(ARCH).reduced()
    params = jtf.init_params(jax.random.PRNGKey(1), cfg)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    tcfg = tget_config(ARCH).reduced()
    return cfg, tcfg, params, model_from_numpy(np_params, tcfg, "cpu")


# prompt 72 + 8 new tokens passes the serve window of 64
@pytest.mark.parametrize("prompt_len,gen", [(12, 6), (72, 8)])
def test_greedy_generate_matches_reference(models, prompt_len, gen):
    cfg, tcfg, params, model = models
    prompts = np.random.default_rng(prompt_len).integers(
        0, cfg.vocab_size, (3, prompt_len))
    want, _ = jserve.generate(params, cfg, jnp.asarray(prompts, jnp.int32),
                              gen)
    got, stats = tserve.generate(model, tcfg, torch.from_numpy(prompts), gen,
                                 device="cpu")
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape == (3, prompt_len + gen)
    np.testing.assert_array_equal(got[:, :prompt_len], prompts)
    assert len(stats["decode_ms"]) == gen - 1
    # the reference's logits for each new token (the serve window also
    # limits the prompt pass, so these are the decode steps' logits)
    logits, _ = jax.jit(lambda p, t: jtf.prefill_with_cache(
        p, cfg, {"tokens": t}))(params, jnp.asarray(want[:, :-1]))
    logits = np.asarray(logits)[:, prompt_len - 1:]
    tol = 1e-4 * float(np.abs(logits).max())
    top2 = np.sort(logits, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > tol
    compared = 0
    for row in range(3):
        for i in range(gen):
            if not clear[row, i]:
                break
            assert got[row, prompt_len + i] == want[row, prompt_len + i], \
                (row, i)
            compared += 1
    assert compared >= 3 * gen - 2     # near-ties are rare at these sizes


def test_sampling_repeats_with_a_fixed_generator(models):
    _, tcfg, _, model = models
    prompts = torch.from_numpy(np.random.default_rng(5).integers(
        0, tcfg.vocab_size, (2, 10)))
    runs = [tserve.generate(model, tcfg, prompts, 12, temperature=0.9,
                            generator=torch.Generator().manual_seed(seed),
                            device="cpu")[0]
            for seed in (3, 3, 4)]
    assert torch.equal(runs[0], runs[1])
    assert runs[0].shape == (2, 22)
    assert int(runs[0].max()) < tcfg.vocab_size
    greedy, _ = tserve.generate(model, tcfg, prompts, 12, device="cpu")
    # the first new token is always the prefill's argmax
    assert torch.equal(runs[0][:, 10], greedy[:, 10])
    assert not torch.equal(runs[0], greedy) or not torch.equal(runs[0],
                                                               runs[2])


def test_main_runs_on_the_cpu(capsys):
    tokens = tserve.main(["--reduced", "--batch", "2", "--prompt-len", "8",
                          "--gen", "4", "--device", "cpu"])
    assert tokens.shape == (2, 12) and tokens.device.type == "cpu"
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "arch=qwen2-0.5b batch=2 prompt=8 gen=4"
    assert out[1].startswith("prefill ") and "tok/s" in out[1]
    assert out[2] == f"sample row: {tokens[0, -4:].tolist()}"


def test_main_sampling_is_seeded():
    argv = ["--reduced", "--batch", "2", "--prompt-len", "8", "--gen", "6",
            "--temperature", "0.7", "--device", "cpu"]
    assert torch.equal(tserve.main(argv + ["--seed", "2"]),
                       tserve.main(argv + ["--seed", "2"]))


def test_encoder_only_arch_is_refused():
    with pytest.raises(SystemExit, match="encoder-only"):
        tserve.main(["--arch", "hubert-xlarge", "--reduced", "--device",
                     "cpu"])


def test_generate_keeps_the_cache_capacity_at_prompt_plus_gen(models):
    _, tcfg, _, model = models
    prompts = torch.zeros((1, 5), dtype=torch.long)
    _, cache = ttf.prefill_with_cache(model, tcfg, {"tokens": prompts},
                                      capacity=5 + 3)
    assert cache.layers[0]["k"].shape[2] == 8 and cache.pos == 5


# the tolerance of the full-size bf16 check in chip_smoke.py phase 4c,
# which plants the same head in qwen2-0.5b at full width
BF16_REL_TOL = 2.0 ** -4


def _planted(models):
    """The reduced model with a planted previous-token head, as the port's
    model and as the reference's parameter tree."""
    cfg, tcfg, params, _ = models
    np_params = jax.tree_util.tree_map(np.asarray, params)
    model = model_from_numpy(np_params, tcfg, "cpu")
    head = plant_previous_token_head(model, tcfg, seed=0)
    planted = dict(np_params)
    planted["embed"] = model.embed.numpy().copy()
    attn = {name: np.array(w) for name, w in
            np_params["layers"]["attn"].items()}
    for name in attn:
        attn[name][0] = getattr(model.layers[0].attn, name).numpy()
    planted["layers"] = {**np_params["layers"], "attn": attn}
    return model, jax.tree_util.tree_map(jnp.asarray, planted), head


def test_greedy_tokens_match_reference_on_planted_margin(models):
    """With a planted previous-token head every generated position is
    compared: the continuation is known, the top-2 margin is asserted
    first, then the port's tokens must equal the reference's, the known
    continuation and the argmax of a prefill over them."""
    cfg, tcfg, _, _ = models
    model, jparams, head = _planted(models)
    prompt_len, gen = 72, 8            # past the serve window of 64
    prompts = np.random.default_rng(3).integers(0, cfg.vocab_size,
                                                (3, prompt_len))
    want, _ = jserve.generate(jparams, cfg, jnp.asarray(prompts, jnp.int32),
                              gen)
    want = np.asarray(want)
    logits, _ = jax.jit(lambda p, t: jtf.prefill_with_cache(
        p, cfg, {"tokens": t}))(jparams, jnp.asarray(want[:, :-1]))
    logits = np.asarray(logits, np.float64)[:, prompt_len - 1:]
    top2 = np.sort(logits, axis=-1)[..., -2:]
    margin = (top2[..., 1] - top2[..., 0]) / np.abs(logits).max()
    assert margin.min() > BF16_REL_TOL, margin.min()
    got, _ = tserve.generate(model, tcfg, torch.from_numpy(prompts), gen,
                             device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[:, prompt_len:].numpy(),
                                  continuation(prompts, gen, head))
    # no row is its input token repeated
    new = got[:, prompt_len:].numpy()
    assert (new[:, 1:] != new[:, :-1]).any(axis=1).all()
    # the port's own decode against its prefill over the same tokens
    with torch.inference_mode():
        tlogits, _ = ttf.prefill_with_cache(
            model, tcfg, {"tokens": got[:, :-1]})
    np.testing.assert_array_equal(
        torch.argmax(tlogits[:, prompt_len - 1:], dim=-1).numpy(),
        got[:, prompt_len:].numpy())


@pytest.mark.parametrize("corrupt", ["negate_v", "shift_v", "swap_rows"])
def test_planted_tokens_change_on_a_corrupted_cache(models, corrupt):
    """The planted head reads the cache entry one position back, so a
    decode from a corrupted cache picks another token than the known
    continuation: the token check of the planted weights sees the cache.
    Layer 0's values negated, moved one ring slot on, or taken from the
    row before."""
    _, tcfg, _, _ = models
    model, _, head = _planted(models)
    prompt_len, gen = 72, 2
    prompts = np.random.default_rng(5).integers(0, tcfg.vocab_size,
                                                (8, prompt_len))
    want = continuation(prompts, gen, head)
    with torch.inference_mode():
        logits, cache = ttf.prefill_with_cache(
            model, tcfg, {"tokens": torch.from_numpy(prompts)},
            capacity=prompt_len + gen)
        first = torch.argmax(logits[:, -1], dim=-1)
        np.testing.assert_array_equal(first.numpy(), want[:, 0])
        v = cache.layers[0]["v"]
        if corrupt == "negate_v":
            v.neg_()
        elif corrupt == "shift_v":
            v.copy_(torch.roll(v, 1, dims=2))
        else:
            v.copy_(torch.roll(v, 1, dims=0))
        lg, _ = ttf.decode_step(model, tcfg, cache, first[:, None])
    got = torch.argmax(lg[:, -1], dim=-1).numpy()
    # a row's token changes where the value read one position back
    # changed sign
    prev, before = prompts[:, -1], prompts[:, -2]
    flipped = {"negate_v": np.ones(len(prompts), bool),
               "shift_v": head.signs[prev] != head.signs[before],
               "swap_rows": head.signs[prev] != head.signs[np.roll(prev, 1)]
               }[corrupt]
    assert flipped.any()
    np.testing.assert_array_equal(got != want[:, 1], flipped)
