"""The port's model families against ``repro``: the SSD block (Mamba-2,
Hymba), the MoE layer (Qwen3-MoE, Grok-1), the VLM's cross-attention layer,
and ``forward`` / ``prefill`` / ``decode_step`` on every architecture's
SMOKE config.

Inputs are made with numpy from a seed and given to both packages;
``repro``'s parameters are carried across with ``params_from_numpy``, so
both compute with the same weights.  Everything runs in float32 on the
CPU, ``repro`` through its jitted functions.  Tolerance: ``MODEL_TOL``
(rtol = atol = 1e-4), for the summation order of a few float32 layers
(XLA and PyTorch sum products, softmaxes and the SSD's chunk terms in
other orders); no family needs more.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
import repro.models.layers as jl
import repro.models.moe as jmoe
import repro.models.ssm as jssm
import repro.models.transformer as jt
import repro_torch.configs as tcfgs
import repro_torch.models.moe as tmoe
import repro_torch.models.ssm as tssm
import repro_torch.models.transformer as tt

MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
CAUSAL = [a for a in jcfgs.ARCH_IDS if jcfgs.get_smoke(a).causal]


def close(got, want, tol=MODEL_TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def flat(tree, prefix=""):
    """(path, leaf) pairs of a nested dict, in sorted path order."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from flat(tree[k], f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", tree[k]


def close_trees(got, want):
    got, want = dict(flat(got)), dict(flat(want))
    assert set(got) == set(want)
    for path, w in want.items():
        assert tuple(got[path].shape) == w.shape, path
        assert str(got[path].dtype).removeprefix("torch.") == str(w.dtype), path
        close(got[path], w)


def layer0(tree):
    """Layer 0 of a stacked repro parameter tree, as numpy."""
    return jax.tree.map(lambda a: np.asarray(a)[0], tree)


def port(tree):
    return tt.params_from_numpy(tree, device="cpu")


def randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape, dtype=np.float32) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# The SSD block.
# ---------------------------------------------------------------------------

def _ssm_params(arch, seed):
    """Layer 0 of repro's init_ssm, with the per-head scalars (zero, one and
    zero at init) drawn so that they count."""
    cfg = jcfgs.get_smoke(arch)
    p = layer0(jssm.init_ssm(jax.random.PRNGKey(seed), cfg, layers=1))
    rng = np.random.default_rng(seed)
    h = cfg.ssm_heads
    p.update(a_log=randn(rng, h, scale=0.5), d_skip=randn(rng, h),
             dt_bias=randn(rng, h, scale=0.5))
    return cfg, tcfgs.get_smoke(arch), p


def test_causal_conv():
    rng = np.random.default_rng(0)
    x, w = randn(rng, 2, 11, 24), randn(rng, 4, 24)
    close(tssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w)),
          jssm._causal_conv(jnp.asarray(x), jnp.asarray(w)))


@pytest.mark.parametrize("arch", ["mamba2_780m", "hymba_1_5b"])
@pytest.mark.parametrize("l", [32, 21])
def test_ssm_apply(arch, l):
    """L = 32: two chunks of 16; L = 21: end-padded to 32 and trimmed."""
    jcfg, tcfg, p = _ssm_params(arch, seed=l)
    x = randn(np.random.default_rng(l), 2, l, jcfg.d_model)
    want = jax.jit(jssm.ssm_apply, static_argnums=2)(p, jnp.asarray(x), jcfg)
    got = tssm.ssm_apply(port(p), torch.from_numpy(x), tcfg)
    assert got.shape == want.shape
    close(got, want)


def test_ssm_decode_after_prefill_state():
    """The closed-form state after 21 tokens, then 5 recurrent steps: each
    step's output equals ``repro``'s ``ssm_apply`` over the longer sequence
    at that position, and every state equals ``repro``'s."""
    jcfg, tcfg, p = _ssm_params("mamba2_780m", seed=3)
    tp = port(p)
    l, steps = 21, 5
    x = randn(np.random.default_rng(3), 2, l + steps, jcfg.d_model)
    full = jax.jit(jssm.ssm_apply, static_argnums=2)(p, jnp.asarray(x), jcfg)
    jst = jax.jit(jt._ssm_prefill_state, static_argnums=2)(p, jnp.asarray(x[:, :l]), jcfg)
    tst = tssm.ssm_prefill_state(tp, torch.from_numpy(x[:, :l]), tcfg)
    close_trees(tst, jst)
    jdecode = jax.jit(jssm.ssm_decode, static_argnums=3)
    for t in range(l, l + steps):
        jy, jst = jdecode(p, jnp.asarray(x[:, t:t + 1]), jst, jcfg)
        ty, tst = tssm.ssm_decode(tp, torch.from_numpy(x[:, t:t + 1]), tst, tcfg)
        close(ty, jy)
        close(ty, full[:, t:t + 1])
        close_trees(tst, jst)


def test_init_ssm_state():
    cfg = tcfgs.get_smoke("hymba_1_5b")
    want = jssm.init_ssm_state(jcfgs.get_smoke("hymba_1_5b"), 3)
    close_trees(tssm.init_ssm_state(cfg, 3, device="cpu"), want)


# ---------------------------------------------------------------------------
# The MoE layer.
# ---------------------------------------------------------------------------

def _routed(cfg, p, x, capacity):
    """The (token, choice) pairs past their expert's capacity."""
    logits = x.reshape(-1, cfg.d_model) @ p["router"]
    ids = np.argsort(-logits, axis=-1)[:, :cfg.experts_per_token].reshape(-1)
    return np.maximum(np.bincount(ids, minlength=cfg.n_experts) - capacity, 0).sum()


@pytest.mark.parametrize("arch,capacity_factor,dropless", [
    ("qwen3_moe_30b_a3b", None, False),     # SMOKE: E/k, no drops
    ("qwen3_moe_30b_a3b", 0.5, False),      # capacity binds: tokens drop
    ("qwen3_moe_30b_a3b", 0.5, True),       # dropless ignores the factor
    ("grok_1_314b", 0.5, False),            # act="gelu", SiLU-gated experts
])
def test_moe_apply(arch, capacity_factor, dropless):
    over = {} if capacity_factor is None else {"capacity_factor": capacity_factor}
    jcfg = dataclasses.replace(jcfgs.get_smoke(arch), **over)
    tcfg = dataclasses.replace(tcfgs.get_smoke(arch), **over)
    p = layer0(jmoe.init_moe(jax.random.PRNGKey(5), jcfg, layers=1))
    x = randn(np.random.default_rng(5), 2, 12, jcfg.d_model)
    dropped = _routed(jcfg, p, x, tmoe.moe_capacity(tcfg, 24, dropless=dropless))
    assert (dropped > 0) == (capacity_factor == 0.5 and not dropless)
    want, jaux = jax.jit(jmoe.moe_apply, static_argnums=2,
                         static_argnames="dropless")(p, jnp.asarray(x), jcfg,
                                                     dropless=dropless)
    got, taux = tmoe.moe_apply(port(p), torch.from_numpy(x), tcfg, dropless=dropless)
    close(got, want)
    assert set(taux) == set(jaux) == {"moe_lb", "moe_z"}
    for key in jaux:
        assert taux[key].dtype == torch.float32
        close(taux[key], jaux[key])


# ---------------------------------------------------------------------------
# The VLM's cross-attention layer.
# ---------------------------------------------------------------------------

def test_cross_block():
    jcfg = jcfgs.get_smoke("llama_3_2_vision_11b")
    tcfg = tcfgs.get_smoke("llama_3_2_vision_11b")
    rng = np.random.default_rng(6)
    cp = {"ln": 1.0 + randn(rng, jcfg.d_model, scale=0.1),
          "attn": layer0(jl.init_attn(jax.random.PRNGKey(6), jcfg, layers=1))}
    x, img = randn(rng, 2, 7, jcfg.d_model), randn(rng, 2, jcfg.vision_seq, jcfg.d_model)
    want = jt._cross_block(jcfg, jnp.asarray(x), cp, jnp.asarray(img))
    tcp, timg = port(cp), torch.from_numpy(img)
    got = tt._cross_block(tcfg, torch.from_numpy(x), tcp, *tt._cross_kv(tcfg, tcp, timg))
    close(got, want)


# ---------------------------------------------------------------------------
# Every architecture through forward, prefill and decode_step.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jitted():
    """repro's forward, prefill and decode_step, jitted once per module."""
    return (jax.jit(jt.forward, static_argnums=1),
            jax.jit(jt.prefill, static_argnums=1, static_argnames="max_len"),
            jax.jit(jt.decode_step, static_argnums=1))


@pytest.fixture(scope="module")
def models():
    """``models(arch, **overrides)``: (repro config, port config, repro
    params, port params) for ``arch``'s SMOKE config with ``overrides``,
    initialized once per module."""
    built = {}

    def get(arch, **overrides):
        key = (arch, tuple(sorted(overrides.items())))
        if key not in built:
            jcfg = dataclasses.replace(jcfgs.get_smoke(arch), **overrides)
            tcfg = dataclasses.replace(tcfgs.get_smoke(arch), **overrides)
            jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
            if jcfg.has_ssm:    # zero/one at init; make them count
                rng = np.random.default_rng(1)
                shape = jp["blocks"]["ssm"]["a_log"].shape
                jp["blocks"]["ssm"].update(
                    a_log=jnp.asarray(randn(rng, *shape, scale=0.5)),
                    d_skip=jnp.asarray(randn(rng, *shape)),
                    dt_bias=jnp.asarray(randn(rng, *shape, scale=0.5)))
            built[key] = jcfg, tcfg, jp, port(jax.tree.map(np.asarray, jp))
        return built[key]
    return get


def _inputs(cfg, b, l, seed):
    """(tokens, img, frames) as numpy: tokens (None for the audio encoder),
    image embeddings for the VLM, frames for the audio encoder."""
    rng = np.random.default_rng(seed)
    if cfg.frontend_dim:
        return None, None, randn(rng, b, l, cfg.frontend_dim)
    tokens = rng.integers(0, cfg.vocab_size, (b, l)).astype(np.int32)
    img = randn(rng, b, cfg.vision_seq, cfg.d_model) if cfg.n_cross_layers else None
    return tokens, img, None


def _both(*arrays):
    """Each numpy array (or None) as a (jax, torch) pair."""
    return [(None, None) if a is None else (jnp.asarray(a), torch.from_numpy(a))
            for a in arrays]


@pytest.mark.parametrize("arch,overrides", [(a, {}) for a in jcfgs.ARCH_IDS] + [
    ("qwen3_moe_30b_a3b", {"capacity_factor": 0.5}),    # prefill-time drops
])
def test_forward_matches_repro(models, jitted, arch, overrides):
    jcfg, tcfg, jp, tp = models(arch, **overrides)
    (tj, tt_), (ij, it), (fj, ft) = _both(*_inputs(jcfg, 2, 12, seed=1))
    jlog, jaux = jitted[0](jp, jcfg, tj, img=ij, frames=fj)
    tlog, taux = tt.forward(tp, tcfg, tt_, img=it, frames=ft)
    assert tlog.shape == jlog.shape
    close(tlog, jlog)
    assert taux.dtype == torch.float32 and taux.shape == ()
    close(taux, jaux)
    assert (float(taux) != 0.0) == jcfg.is_moe


@pytest.mark.parametrize("arch,l,max_len", [(a, 12, 20) for a in CAUSAL] + [
    ("mamba2_780m", 37, 45),     # three chunks of 16, end-padded
    ("hymba_1_5b", 37, 45),      # the same, and a rolling window of 16
])
def test_prefill_and_decode_match_repro(models, jitted, arch, l, max_len):
    """prefill's last-token logits and every cache tensor (k, v, ssm.conv,
    ssm.s, cross_k, cross_v, length), then 4 decode steps' logits and
    caches, against repro."""
    jcfg, tcfg, jp, tp = models(arch)
    _, jprefill, jdecode = jitted
    (tj, tt_), (ij, it), _ = _both(*_inputs(jcfg, 2, l, seed=l))
    jlog, jcache = jprefill(jp, jcfg, tj, img=ij, max_len=max_len)
    tlog, tcache = tt.prefill(tp, tcfg, tt_, img=it, max_len=max_len)
    close(tlog, jlog)
    close_trees(tcache, jcache)
    for _ in range(4):
        tok = np.asarray(jnp.argmax(jlog[:, -1], axis=-1))[:, None].astype(np.int32)
        jlog, jcache = jdecode(jp, jcfg, jnp.asarray(tok), jcache)
        tlog, tcache = tt.decode_step(tp, tcfg, torch.from_numpy(tok), tcache)
        close(tlog, jlog)
        close_trees(tcache, jcache)


def test_audio_prefill_matches_repro(models, jitted):
    """The encoder's prefill over frames: last-row logits and its KV cache."""
    jcfg, tcfg, jp, tp = models("hubert_xlarge")
    _, _, (fj, ft) = _both(*_inputs(jcfg, 2, 12, seed=4))
    jlog, jcache = jitted[1](jp, jcfg, None, frames=fj)
    tlog, tcache = tt.prefill(tp, tcfg, None, frames=ft)
    close(tlog, jlog)
    close_trees(tcache, jcache)


@pytest.mark.parametrize("arch", ["qwen3_moe_30b_a3b", "mamba2_780m", "hymba_1_5b",
                                  "llama_3_2_vision_11b"])
def test_init_cache_matches_repro(arch):
    jcfg, tcfg = jcfgs.get_smoke(arch), tcfgs.get_smoke(arch)
    close_trees(tt.init_cache(tcfg, 3, 24, device="cpu"), jt.init_cache(jcfg, 3, 24))


@pytest.mark.parametrize("arch", ["qwen3_moe_30b_a3b", "hymba_1_5b", "mamba2_780m"])
def test_params_from_numpy_keeps_each_leafs_dtype(arch):
    """A tree in the layout and dtypes of repro's bfloat16 ``init_params``
    comes across with its float32 leaves (the router, the SSM's per-head
    scalars) still float32 and the rest bfloat16, bit for bit."""
    cfg = dataclasses.replace(jcfgs.get_smoke(arch), dtype="bfloat16")
    rng = np.random.default_rng(2)
    jp = jax.tree.map(lambda a: randn(rng, *a.shape).astype(a.dtype),
                      jax.eval_shape(lambda: jt.init_params(cfg, jax.random.PRNGKey(2))))
    tp = tt.params_from_numpy(jp, device="cpu")
    dtypes = {str(t.dtype).removeprefix("torch.") for _, t in flat(tp)}
    assert dtypes == {"bfloat16", "float32"}
    for (path, got), (_, want) in zip(flat(tp), flat(jp), strict=True):
        assert str(got.dtype).removeprefix("torch.") == str(want.dtype), path
        np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))


@pytest.mark.parametrize("arch", ["qwen3_moe_30b_a3b", "mamba2_780m", "hymba_1_5b",
                                  "llama_3_2_vision_11b", "hubert_xlarge"])
def test_bfloat16_path_keeps_repros_dtypes(arch):
    """The bfloat16 path the card serves runs every family's casts: finite
    bfloat16 logits, a float32 aux, and prefill's and a decode step's cache
    leaves in the dtypes of ``repro``'s bfloat16 ``init_cache`` (``ssm.s``
    float32).  20 tokens: the SSD end-pads, Hymba's window rolls."""
    jcfg = dataclasses.replace(jcfgs.get_smoke(arch), dtype="bfloat16")
    cfg = dataclasses.replace(tcfgs.get_smoke(arch), dtype="bfloat16")
    p = tt.init_params(cfg, torch.Generator().manual_seed(0))
    tokens, img, frames = (None if a is None else torch.from_numpy(a)
                           for a in _inputs(cfg, 2, 20, seed=7))
    img = None if img is None else img.bfloat16()
    logits, aux = tt.forward(p, cfg, tokens, img=img, frames=frames)
    assert logits.dtype == torch.bfloat16 and aux.dtype == torch.float32
    assert torch.isfinite(logits.float()).all()
    want = {path: str(a.dtype) for path, a in
            flat(jax.eval_shape(lambda: jt.init_cache(jcfg, 2, 24)))}
    last, cache = tt.prefill(p, cfg, tokens, img=img, frames=frames, max_len=24)
    steps = [(last, cache)]
    if cfg.causal:
        tok = torch.argmax(last[:, -1], dim=-1)[:, None].to(torch.int32)
        steps.append(tt.decode_step(p, cfg, tok, cache))
    for out, c in steps:
        assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
        assert {path: str(t.dtype).removeprefix("torch.") for path, t in flat(c)} == want
