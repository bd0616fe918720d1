"""The port's ServeEngine: ``tests/test_serve.py`` mirrored on the port, and
token-for-token parity with ``repro``'s engine on carried weights.

Everything runs in float32 on the CPU (``device="cpu"``).  Prompts are
left-padded with token 0 and the pads are attended, in both packages:
that is ``repro``'s semantics, which the port keeps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.models.transformer import forward as jax_forward
from repro.models.transformer import init_params as jax_init
from repro.serve.engine import ServeEngine as JaxEngine
from repro_torch.configs import get_smoke
from repro_torch.models.transformer import forward, init_params, params_from_numpy
from repro_torch.serve import ServeEngine


def _params(arch, seed):
    return init_params(get_smoke(arch), torch.Generator().manual_seed(seed))


# -- tests/test_serve.py on the port ----------------------------------------

def test_greedy_generation_matches_forward_argmax():
    cfg = get_smoke("tinyllama_1_1b")
    params = _params("tinyllama_1_1b", 3)
    prompts = [np.array([5, 6, 7, 8], np.int32), np.array([1, 2, 3, 4], np.int32)]
    eng = ServeEngine(cfg, params, batch=2, max_len=32, device="cpu")
    outs = eng.generate(prompts, max_new_tokens=5)
    # Oracle: teacher-force through the port's full forward.
    for i, p in enumerate(prompts):
        seq = list(p)
        for t in range(5):
            logits, _ = forward(params, cfg, torch.tensor([seq], dtype=torch.int32))
            nxt = int(torch.argmax(logits[0, -1]))
            assert outs[i][t] == nxt, (i, t, outs[i], nxt)
            seq.append(nxt)


def test_engine_batches_requests():
    cfg = get_smoke("qwen3_32b")
    eng = ServeEngine(cfg, _params("qwen3_32b", 0), batch=4, max_len=64, device="cpu")
    outs = eng.generate([np.arange(3, dtype=np.int32)] * 3, max_new_tokens=4)
    assert len(outs) == 3 and all(len(o) == 4 for o in outs)
    # Identical prompts -> identical continuations.
    assert outs[0] == outs[1] == outs[2]


def test_engine_per_request_token_budgets():
    """Per-request max_new_tokens: each slot's output stops at its own
    budget, and every emitted prefix matches the shared-budget run."""
    cfg = get_smoke("qwen3_32b")
    eng = ServeEngine(cfg, _params("qwen3_32b", 0), batch=4, max_len=64, device="cpu")
    prompts = [np.arange(3, dtype=np.int32),
               np.arange(1, 4, dtype=np.int32),
               np.arange(2, 5, dtype=np.int32)]
    shared = eng.generate(prompts, max_new_tokens=5)
    limits = [5, 2, 0]
    capped = eng.generate(prompts, max_new_tokens=limits)
    assert [len(o) for o in capped] == limits
    for full, cut, lim in zip(shared, capped, limits):
        assert cut == full[:lim]


def test_engine_rejects_more_prompts_than_slots():
    cfg = get_smoke("qwen3_32b")
    eng = ServeEngine(cfg, _params("qwen3_32b", 0), batch=2, max_len=64, device="cpu")
    with pytest.raises(ValueError, match="batch of 2"):
        eng.generate([np.arange(3, dtype=np.int32)] * 3, max_new_tokens=2)


# -- parity with repro's engine ------------------------------------------------

@pytest.fixture(scope="module")
def engines():
    """``engines(arch)``: repro's and the port's engine (batch 4) on the same
    weights, built once per module (repro's jits its decode step)."""
    built = {}

    def get(arch):
        if arch not in built:
            jcfg = jax_smoke(arch)
            jp = jax_init(jcfg, jax.random.PRNGKey(11))
            tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
            built[arch] = (JaxEngine(jcfg, jp, batch=4, max_len=64),
                           ServeEngine(get_smoke(arch), tp, batch=4, max_len=64,
                                       device="cpu"))
        return built[arch]
    return get


def _prompts(lengths, vocab, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, n).astype(np.int32) for n in lengths]


@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "qwen3_32b", "qwen1_5_32b"])
@pytest.mark.parametrize("lengths,budget", [
    ((6, 6, 6), 6),             # equal lengths
    ((9, 3, 6, 1), 5),          # unequal: left padding, pads attended
    ((7, 4, 5), [5, 2, 0]),     # per-request budgets
])
def test_generate_matches_repro(engines, arch, lengths, budget):
    jeng, teng = engines(arch)
    prompts = _prompts(lengths, get_smoke(arch).vocab_size, seed=sum(lengths))
    got = teng.generate(prompts, max_new_tokens=budget)
    want = jeng.generate(prompts, max_new_tokens=budget)
    assert got == want
    limits = [budget] * len(lengths) if isinstance(budget, int) else budget
    assert [len(o) for o in got] == limits


def test_left_pad_tokens_are_attended():
    """A prompt's continuation depends on the pads in front of it: the same
    prompt served beside a longer one (so padded) and alone differs in its
    first logits, in both packages alike (repro passes no padding mask)."""
    cfg = get_smoke("tinyllama_1_1b")
    jp = jax_init(jax_smoke("tinyllama_1_1b"), jax.random.PRNGKey(11))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    short = np.arange(1, 4, dtype=np.int32)
    alone, _ = forward(tp, cfg, torch.from_numpy(short[None]))
    padded, _ = forward(tp, cfg, torch.from_numpy(np.concatenate([[0, 0, 0], short])[None]))
    assert not torch.allclose(alone[0, -1], padded[0, -1], atol=1e-4)
    jpad, _ = jax_forward(jp, jax_smoke("tinyllama_1_1b"),
                          jnp.asarray(np.concatenate([[0, 0, 0], short])[None]))
    np.testing.assert_allclose(padded.numpy(), np.asarray(jpad), rtol=1e-4, atol=1e-4)
