"""The port's model configs, layers and dense transformer against ``repro``.

Inputs are made with numpy from a seed and given to both packages;
``repro``'s parameters are carried across with ``params_from_numpy``, so
both compute with the same weights.  Everything runs in float32 on the
CPU.  Tolerances: 1e-5 for one layer; 1e-4 for the transformer's logits
and caches, for the summation order of a few float32 layers (XLA and
PyTorch sum the products and the softmax in other orders).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
import repro.models.layers as jl
import repro.models.transformer as jt
import repro_torch.configs as tcfgs
import repro_torch.models.layers as tl
import repro_torch.models.transformer as tt

DENSE = ["tinyllama_1_1b", "stablelm_1_6b", "qwen3_32b", "qwen1_5_32b"]
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


def close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def both(*arrays):
    """Each numpy array as a (jax, torch) pair."""
    return [(jnp.asarray(a), torch.from_numpy(np.array(a))) for a in arrays]


# ---------------------------------------------------------------------------
# Configs.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", jcfgs.ARCH_IDS)
def test_config_copies_are_equal(arch):
    for getter in ("get_config", "get_smoke"):
        want = getattr(jcfgs, getter)(arch)
        got = getattr(tcfgs, getter)(arch)
        assert type(got).__module__ == "repro_torch.models.config"
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.param_count() == want.param_count()
        assert got.active_param_count() == want.active_param_count()
        assert (got.head_dim, got.q_group) == (want.head_dim, want.q_group)
    assert list(tcfgs.cells(arch)) == list(jcfgs.cells(arch))


def test_config_registry_is_equal():
    assert tcfgs.ARCH_IDS == jcfgs.ARCH_IDS and tcfgs.ALIASES == jcfgs.ALIASES
    assert ({k: dataclasses.asdict(v) for k, v in tcfgs.SHAPES.items()}
            == {k: dataclasses.asdict(v) for k, v in jcfgs.SHAPES.items()})
    assert tcfgs.get_config("tinyllama-1-1b").name == "tinyllama-1.1b"


# ---------------------------------------------------------------------------
# Layers.
# ---------------------------------------------------------------------------

def test_rms_norm_and_rope():
    rng = np.random.default_rng(0)
    (xj, xt), (sj, st) = both(rng.standard_normal((2, 7, 3, 16), dtype=np.float32),
                              rng.standard_normal((16,), dtype=np.float32))
    close(tl.rms_norm(xt, st, 1e-6), jl.rms_norm(xj, sj, 1e-6), LAYER_TOL)
    pos = np.arange(5, 12)
    close(tl.rope(xt, torch.from_numpy(pos), 10_000.0),
          jl.rope(xj, jnp.asarray(pos), 10_000.0), LAYER_TOL)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 8), (False, 8)])
def test_mask_bias(causal, window):
    qp, kp = np.arange(3, 20), np.arange(0, 25)
    got = tl._mask_bias(torch.from_numpy(qp), torch.from_numpy(kp),
                        causal=causal, window=window)
    want = jl._mask_bias(jnp.asarray(qp), jnp.asarray(kp), causal=causal, window=window)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _qkv(b, lq, lk, hq, hkv, dh, seed):
    rng = np.random.default_rng(seed)
    return both(rng.standard_normal((b, lq, hq, dh), dtype=np.float32),
                rng.standard_normal((b, lk, hkv, dh), dtype=np.float32),
                rng.standard_normal((b, lk, hkv, dh), dtype=np.float32))


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 8)])
def test_attention_dense(causal, window):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(2, 24, 24, 6, 2, 16, seed=1)
    pos = np.arange(24)
    got = tl.attention_dense(qt, kt, vt, torch.from_numpy(pos), torch.from_numpy(pos),
                             causal=causal, window=window)
    want = jl.attention_dense(qj, kj, vj, jnp.asarray(pos), jnp.asarray(pos),
                              causal=causal, window=window)
    close(got, want, LAYER_TOL)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 8)])
def test_attention_chunked(causal, window):
    """Several q and k chunks; equal to repro's chunked and to the dense."""
    (qj, qt), (kj, kt), (vj, vt) = _qkv(2, 32, 32, 4, 2, 16, seed=2)
    pos = np.arange(32)
    tpos, jpos = torch.from_numpy(pos), jnp.asarray(pos)
    got = tl.attention_chunked(qt, kt, vt, tpos, tpos, causal=causal, window=window,
                               q_chunk=16, k_chunk=8)
    want = jl.attention_chunked(qj, kj, vj, jpos, jpos, causal=causal, window=window,
                                q_chunk=16, k_chunk=8)
    close(got, want, LAYER_TOL)
    close(got, tl.attention_dense(qt, kt, vt, tpos, tpos, causal=causal, window=window)
          .numpy(), LAYER_TOL)
    with pytest.raises(ValueError, match="chunk size"):
        tl.attention_chunked(qt, kt, vt, tpos, tpos, causal=causal, q_chunk=12)


@pytest.mark.parametrize("window", [0, 4])
def test_attention_decode(window):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(3, 1, 16, 8, 2, 8, seed=3)
    got = tl.attention_decode(qt, kt, vt, torch.tensor(11, dtype=torch.int32),
                              window=window)
    want = jl.attention_decode(qj, kj, vj, jnp.int32(11), window=window)
    close(got, want, LAYER_TOL)


@pytest.mark.parametrize("arch", ["qwen3_32b", "qwen1_5_32b", "tinyllama_1_1b"])
def test_qkv_project(arch):
    cfg = jcfgs.get_smoke(arch)
    p = jax.tree.map(lambda a: np.asarray(a)[0],
                     jl.init_attn(jax.random.PRNGKey(4), cfg, layers=1))
    if cfg.qkv_bias:      # repro initializes biases to zero; make them count
        rng = np.random.default_rng(4)
        p.update({k: rng.standard_normal(p[k].shape, dtype=np.float32)
                  for k in ("bq", "bk", "bv")})
    x = np.random.default_rng(5).standard_normal((2, 9, cfg.d_model), dtype=np.float32)
    pos = np.arange(9)
    got = tl.qkv_project(tt.params_from_numpy(p, device="cpu"), torch.from_numpy(x),
                         tcfgs.get_smoke(arch), torch.from_numpy(pos))
    want = jl.qkv_project(p, jnp.asarray(x), cfg, jnp.asarray(pos))
    for g, w in zip(got, want, strict=True):
        close(g, w, LAYER_TOL)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp_apply(act):
    cfg = dataclasses.replace(jcfgs.get_smoke("tinyllama_1_1b"), act=act)
    p = jax.tree.map(lambda a: np.asarray(a)[0],
                     jl.init_mlp(jax.random.PRNGKey(6), cfg, layers=1))
    x = np.random.default_rng(6).standard_normal((2, 5, cfg.d_model), dtype=np.float32)
    got = tl.mlp_apply(tt.params_from_numpy(p, device="cpu"), torch.from_numpy(x),
                       dataclasses.replace(tcfgs.get_smoke("tinyllama_1_1b"), act=act))
    close(got, jl.mlp_apply(p, jnp.asarray(x), cfg), LAYER_TOL)


# ---------------------------------------------------------------------------
# The dense transformer, with repro's weights carried across.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jitted():
    """repro's forward, prefill and decode_step, jitted once per module."""
    return (jax.jit(jt.forward, static_argnums=1),
            jax.jit(jt.prefill, static_argnums=1, static_argnames="max_len"),
            jax.jit(jt.decode_step, static_argnums=1))


def _build(arch, overrides):
    jcfg = dataclasses.replace(jcfgs.get_smoke(arch), **overrides)
    tcfg = dataclasses.replace(tcfgs.get_smoke(arch), **overrides)
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    if jcfg.qkv_bias:     # zero at init in repro; give them values that count
        rng = np.random.default_rng(9)
        jp["blocks"]["attn"].update({
            k: jnp.asarray(rng.standard_normal(jp["blocks"]["attn"][k].shape,
                                               dtype=np.float32) * 0.1)
            for k in ("bq", "bk", "bv")})
    tp = tt.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def models():
    """``models(arch, **overrides)``: (repro config, port config, repro
    params, port params) for ``arch``'s SMOKE config with ``overrides``,
    initialized once per module."""
    built = {}

    def get(arch, **overrides):
        key = (arch, tuple(sorted(overrides.items())))
        if key not in built:
            built[key] = _build(arch, overrides)
        return built[key]
    return get


def _tokens(cfg, b, l, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, l)).astype(np.int32)


def _check_serving(models, jitted, arch, l, max_len, steps=4, **overrides):
    """prefill's last-token logits and every cache tensor, then ``steps``
    decode steps' logits and caches, against repro."""
    jcfg, tcfg, jp, tp = models(arch, **overrides)
    _, jprefill, jdecode = jitted
    toks = _tokens(jcfg, 2, l, seed=l)
    jlog, jcache = jprefill(jp, jcfg, jnp.asarray(toks), max_len=max_len)
    tlog, tcache = tt.prefill(tp, tcfg, torch.from_numpy(toks), max_len=max_len)
    close(tlog, jlog, MODEL_TOL)
    assert set(tcache) == set(jcache)
    for key in jcache:
        assert tuple(tcache[key].shape) == jcache[key].shape, key
        close(tcache[key], jcache[key], MODEL_TOL)
    for _ in range(steps):
        tok = np.asarray(jnp.argmax(jlog[:, -1], axis=-1))[:, None].astype(np.int32)
        jlog, jcache = jdecode(jp, jcfg, jnp.asarray(tok), jcache)
        tlog, tcache = tt.decode_step(tp, tcfg, torch.from_numpy(tok), tcache)
        close(tlog, jlog, MODEL_TOL)
        for key in jcache:
            close(tcache[key], jcache[key], MODEL_TOL)


@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches_repro(models, jitted, arch):
    jcfg, tcfg, jp, tp = models(arch)
    jforward = jitted[0]
    toks = _tokens(jcfg, 2, 12, seed=1)
    jlog, jaux = jforward(jp, jcfg, jnp.asarray(toks))
    tlog, taux = tt.forward(tp, tcfg, torch.from_numpy(toks))
    assert tlog.shape == jlog.shape
    close(tlog, jlog, MODEL_TOL)
    assert float(taux) == float(jaux) == 0.0


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_repro(models, jitted, arch):
    _check_serving(models, jitted, arch, l=12, max_len=20)


def test_chunked_attention_branch_matches_repro(models, jitted):
    """L = 32 > attn_chunk_threshold = 16: both packages take the chunked
    branch (2 q chunks of 16, 4 k chunks of 8) in forward and prefill."""
    over = dict(attn_chunk_threshold=16, attn_q_chunk=16, attn_k_chunk=8)
    jcfg, tcfg, jp, tp = models("tinyllama_1_1b", **over)
    toks = _tokens(jcfg, 2, 32, seed=2)
    close(tt.forward(tp, tcfg, torch.from_numpy(toks))[0],
          jitted[0](jp, jcfg, jnp.asarray(toks))[0], MODEL_TOL)
    _check_serving(models, jitted, "tinyllama_1_1b", l=32, max_len=36, **over)


@pytest.mark.parametrize("l", [12, 6])
def test_sliding_window_rolling_cache_matches_repro(models, jitted, l):
    """window 8: a 12-token prompt fills the rolling buffer in rolling order
    (prefill's ``take``), a 6-token one leaves it padded; decode steps then
    wrap around the buffer."""
    _check_serving(models, jitted, "qwen3_32b", l=l, max_len=l + 6, steps=5,
                   sliding_window=8)


@pytest.mark.parametrize("arch", ["qwen3_moe_30b_a3b", "mamba2_780m", "llama_3_2_vision_11b",
                                  "hubert_xlarge"])
def test_unported_families_raise(arch):
    cfg = tcfgs.get_smoke(arch)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tt.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tt.forward({}, cfg, torch.zeros((1, 4), dtype=torch.int32))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tt.prefill({}, cfg, torch.zeros((1, 4), dtype=torch.int32))


@pytest.mark.parametrize("arch", DENSE)
def test_init_params_has_repros_paths_and_layouts(arch):
    tcfg = tcfgs.get_smoke(arch)
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                        jt.init_params(jcfgs.get_smoke(arch), jax.random.PRNGKey(0)))
    p = tt.init_params(tcfg, torch.Generator().manual_seed(3))
    got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).removeprefix("torch.")), p)
    assert got == want
    again = tt.init_params(tcfg, torch.Generator().manual_seed(3))
    assert torch.equal(p["blocks"]["attn"]["wq"], again["blocks"]["attn"]["wq"])
    bf16 = tt.init_params(dataclasses.replace(tcfg, dtype="bfloat16"),
                          torch.Generator().manual_seed(3))
    assert torch.equal(bf16["lm_head"], p["lm_head"].to(torch.bfloat16))
