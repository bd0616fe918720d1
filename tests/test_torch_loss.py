"""The port's training loss against ``repro``: ``lm_loss`` and its gradients
on every architecture's SMOKE config, with remat ``"full"`` and ``"dots"``,
and ``_attn_core``'s bf16-operand backward against ``jax.vjp``.

Inputs come from ``SyntheticLMData`` (numpy, from a seed); ``repro``'s
parameters are carried across with ``params_from_numpy``, so both packages
differentiate the same function at the same point, in float32 on the CPU,
``repro`` through ``jax.jit(jax.value_and_grad(lm_loss))``.

Tolerances: the loss within ``LOSS_RTOL`` (1e-5 relative) of ``repro``'s;
every gradient leaf within ``GRAD_TOL`` (1e-4) of ``repro``'s, measured
against that leaf's largest magnitude (XLA and PyTorch sum the products,
softmaxes and the SSD's chunk terms in other orders; a relative measure per
element would divide by gradients that cancel to near zero).  Remat changes
what the backward pass keeps, not a number: the port's gradients with remat
equal its own without, element for element.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import CheckpointPolicy

import repro.configs as jcfgs
import repro.models.layers as jl
import repro.models.transformer as jt
import repro_torch.configs as tcfgs
import repro_torch.models.layers as tl
import repro_torch.models.transformer as tt
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.train.tree import flatten, tree_map

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
REMAT_ARCHS = ["tinyllama_1_1b", "qwen3_moe_30b_a3b"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One thread, as the suite's workers share the cores: at these sizes
    more threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape, dtype=np.float32) * scale).astype(np.float32)


@pytest.fixture(scope="module")
def models():
    """``models(arch)``: (repro config, port config, repro params, port
    params) for ``arch``'s SMOKE config, initialized once per module; the
    SSM's per-head scalars (zero, one and zero at init) drawn so that their
    gradients count."""
    built = {}

    def get(arch):
        if arch not in built:
            jcfg, tcfg = jcfgs.get_smoke(arch), tcfgs.get_smoke(arch)
            jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
            if jcfg.has_ssm:
                rng = np.random.default_rng(1)
                shape = jp["blocks"]["ssm"]["a_log"].shape
                jp["blocks"]["ssm"].update(
                    a_log=jnp.asarray(randn(rng, *shape, scale=0.5)),
                    d_skip=jnp.asarray(randn(rng, *shape)),
                    dt_bias=jnp.asarray(randn(rng, *shape, scale=0.5)))
            built[arch] = (jcfg, tcfg, jp,
                           tt.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu"))
        return built[arch]
    return get


def batch_of(cfg, b=2, l=32, step=0):
    """``train_loop``'s batch for ``cfg`` at ``step``, as numpy."""
    return SyntheticLMData(
        vocab_size=cfg.vocab_size, seq_len=l, global_batch=b, seed=3,
        frontend_dim=cfg.frontend_dim,
        vision_seq=cfg.vision_seq if cfg.n_cross_layers else 0,
        d_model=cfg.d_model).batch_at(step)


def repro_value_and_grad(jcfg, jp, batch):
    fn = jax.jit(jax.value_and_grad(lambda p, b: jt.lm_loss(p, jcfg, b), has_aux=True))
    (loss, metrics), grads = fn(jp, {k: None if v is None else jnp.asarray(v)
                                     for k, v in batch.items()})
    return float(loss), {k: float(v) for k, v in metrics.items()}, grads


def port_value_and_grad(tcfg, tp, batch):
    """(loss, metrics, {path: gradient}) of the port's ``lm_loss``."""
    params = tree_map(lambda t: t.detach().clone().requires_grad_(), tp)
    flat = flatten(params)
    loss, metrics = tt.lm_loss(params, tcfg, {k: None if v is None else torch.from_numpy(v)
                                              for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(flat.values()), allow_unused=True,
                                materialize_grads=True)     # the audio encoder's embed
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            dict(zip(flat, grads)))


def check_against_repro(got, want):
    """Loss within LOSS_RTOL, every gradient leaf finite and within GRAD_TOL
    of repro's, against the leaf's largest magnitude."""
    (loss, metrics, grads), (jloss, jmetrics, jgrads) = got, want
    assert loss.dtype == torch.float32 and set(metrics) == set(jmetrics) == {"ce", "aux"}
    np.testing.assert_allclose(float(loss), jloss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(metrics["ce"]), jmetrics["ce"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(metrics["aux"]), jmetrics["aux"], rtol=LOSS_RTOL,
                               atol=1e-8)
    jflat = {"/".join(str(p.key) for p in path): np.asarray(g)
             for path, g in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    assert set(grads) == set(jflat)
    for path, w in jflat.items():
        g = grads[path].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, path
        assert np.isfinite(g).all(), path
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max())
        assert err <= GRAD_TOL * scale, (path, err, scale)


@pytest.mark.parametrize("arch", jcfgs.ARCH_IDS)
def test_lm_loss_and_grads_match_repro(models, arch):
    jcfg, tcfg, jp, tp = models(arch)
    batch = batch_of(jcfg)
    check_against_repro(port_value_and_grad(tcfg, tp, batch),
                        repro_value_and_grad(jcfg, jp, batch))


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_remat_matches_repro_and_changes_no_number(models, arch, remat):
    jcfg, tcfg, jp, tp = models(arch)
    batch = batch_of(jcfg)
    got = port_value_and_grad(dataclasses.replace(tcfg, remat=remat), tp, batch)
    check_against_repro(got, repro_value_and_grad(dataclasses.replace(jcfg, remat=remat),
                                                  jp, batch))
    loss, _, grads = port_value_and_grad(tcfg, tp, batch)    # SMOKE: remat "none"
    assert tcfg.remat == "none" and torch.equal(got[0], loss)
    for path, g in grads.items():
        assert torch.equal(got[2][path], g), path


def test_remat_dots_saves_the_products_without_batch_dims(models, monkeypatch):
    """``"dots"`` saves the outputs of the ``x @ W`` products (``mm``: the
    block's 7, q/k/v/o and the MLP's three) and recomputes every other
    operation, the attention's batched products among them."""
    _, tcfg, _, tp = models("tinyllama_1_1b")
    decided, save_dots = [], tt._save_dots

    def policy(ctx, op, *args, **kwargs):
        out = save_dots(ctx, op, *args, **kwargs)
        if not ctx.is_recompute:
            decided.append((op, out))
        return out

    monkeypatch.setattr(tt, "_save_dots", policy)
    port_value_and_grad(dataclasses.replace(tcfg, remat="dots"), tp, batch_of(tcfg))
    saved = [op for op, out in decided if out == CheckpointPolicy.MUST_SAVE]
    assert saved == [torch.ops.aten.mm.default] * 7 * tcfg.n_layers
    assert torch.ops.aten.bmm.default in {op for op, _ in decided}


def test_loss_masks_negative_labels(models):
    """A label < 0 drops out of the mean, as in repro."""
    jcfg, tcfg, jp, tp = models("stablelm_1_6b")
    batch = batch_of(jcfg)
    labels = batch["labels"].copy()
    labels[:, ::3] = -1
    batch["labels"] = labels
    check_against_repro(port_value_and_grad(tcfg, tp, batch),
                        repro_value_and_grad(jcfg, jp, batch))


# ---------------------------------------------------------------------------
# _attn_core: the bf16-operand backward.
# ---------------------------------------------------------------------------

# Against each output's largest magnitude. float32: the two packages' products
# and softmaxes sum in other orders. bfloat16: the backward rounds p, dO, dS
# and every output to bf16, so a sum that lands on the other side of a
# rounding moves an element by one bf16 ulp: two ulps of the largest value.
ATTN_TOL = {"float32": 1e-5, "bfloat16": 2 ** -7}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_attn_core_matches_jax_vjp(dtype, causal):
    """Forward and (dq, dk, dv), GQA with 4 query heads per kv head."""
    rng = np.random.default_rng(7)
    b, lq, lk, hq, hkv, dh = 2, 12, 12, 8, 2, 16
    q, k, v = (randn(rng, b, lq, hq, dh), randn(rng, b, lk, hkv, dh),
               randn(rng, b, lk, hkv, dh))
    do = randn(rng, b, lq, hq, dh)
    pos = np.arange(lq)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jbias = jl._mask_bias(jnp.asarray(pos), jnp.asarray(pos), causal=causal, window=0)
    out, vjp = jax.vjp(jl._attn_core, *(jnp.asarray(a, jdt) for a in (q, k, v)), jbias)
    want = (out,) + vjp(jnp.asarray(do, jdt))[:3]

    tq, tk, tv = (torch.from_numpy(a).to(tdt).requires_grad_() for a in (q, k, v))
    tbias = tl._mask_bias(torch.from_numpy(pos), torch.from_numpy(pos), causal=causal,
                          window=0)
    o = tl._attn_core(tq, tk, tv, tbias)
    got = (o,) + torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do).to(tdt))
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        w = np.asarray(w.astype(jnp.float32))
        assert g.dtype == tdt and tuple(g.shape) == w.shape, name
        err = float(np.abs(g.detach().float().numpy() - w).max())
        assert err <= ATTN_TOL[dtype] * float(np.abs(w).max()), (name, err)
