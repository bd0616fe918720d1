"""The SSD's gradient where a chunk's log decays are large.

Within a chunk the decay from position j to i is ``exp(seg)``, ``seg = cum_i
- cum_j``, kept where i >= j.  Above the diagonal ``seg`` is positive: at the
published width (chunks of 256, ``dt * A`` of about -1 a step at init) it
reaches about 200, whose float32 exp is inf.  ``repro``'s ``where(causal,
exp(seg), 0)`` (``repro/models/ssm.py:91``) then gives the right forward and
a NaN gradient (``where``'s zero times ``exp``'s inf); the port masks ``seg``
before the exp (``repro_torch/models/ssm.py::_ssd_chunks``), the same decays.

The tests run one SSD layer of a SMOKE config whose decays overflow inside a
chunk of 16 (``A = -16``): the port's gradients are finite, ``repro``'s at
the same chunk are not, and the port's equal ``repro``'s at a chunk of 2,
where nothing overflows (the SSD's result does not depend on its chunk).

Run as a script, it checks one Mamba-2 layer at the published width (chunk
256, 4,096 tokens, batch 1, float32, the published init) in both packages
and prints whether each one's gradients are finite (about a minute, 3 GB):

    PYTHONPATH=src python tests/test_torch_ssd_grad.py
"""
from __future__ import annotations

import dataclasses
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
import repro.models.ssm as jssm
import repro_torch.models.ssm as tssm
from repro_torch.models.transformer import params_from_numpy

LARGE_DECAY = math.log(16.0)    # a_log: A = -16, dt * A about -11 a step
TOKENS = (2, 32)
REF_CHUNK = 2                   # one step of decay within a chunk: no overflow
TOL = 1e-5                      # float32, the same sums in another order


def _layer(cfg, seed, a_log=None):
    """(repro's parameters of one SSD layer of ``cfg``, as numpy, ``a_log``
    set where given; an input (B, L, D) and the output's cotangent)."""
    p = jax.tree.map(lambda t: np.asarray(t[0]),
                     jssm.init_ssm(jax.random.PRNGKey(seed), cfg, layers=1))
    if a_log is not None:
        p["a_log"] = np.full_like(p["a_log"], a_log)
    rng = np.random.default_rng(seed)
    b, l = TOKENS if a_log is not None else (1, 4096)
    x = rng.standard_normal((b, l, cfg.d_model)).astype(np.float32)
    return p, x, rng.standard_normal(x.shape).astype(np.float32)


def _repro_grads(cfg, p, x, r):
    """repro's gradients of ``sum(ssm_apply(p, x) * r)`` by parameter, and
    the input's under ``"x"``."""
    def loss(p, x):
        return jnp.sum(jssm.ssm_apply(p, x, cfg) * r)

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    return {**{k: np.asarray(v) for k, v in gp.items()}, "x": np.asarray(gx)}


def _port_grads(cfg, p, x, r):
    """The port's gradients, as :func:`_repro_grads`."""
    tp = {k: v.requires_grad_(True) for k, v in params_from_numpy(p, device="cpu").items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y = tssm.ssm_apply(tp, tx, cfg)
    grads = torch.autograd.grad((y * torch.from_numpy(r)).sum(), [*tp.values(), tx])
    return {k: g.numpy() for k, g in zip([*tp, "x"], grads)}


def _finite(grads) -> bool:
    return all(np.isfinite(g).all() for g in grads.values())


@pytest.mark.parametrize("arch", ["mamba2_780m", "hymba_1_5b"])
def test_ssd_gradient_where_the_decay_overflows(arch):
    """A chunk of 16 whose decays overflow: the port's gradients are finite
    and within 1e-5 of repro's at a chunk of 2; repro's own at 16 are not
    finite (the input does reach the overflow)."""
    cfg = jcfgs.get_smoke(arch)
    assert cfg.ssm_chunk == 16
    p, x, r = _layer(cfg, 3, a_log=LARGE_DECAY)
    got = _port_grads(cfg, p, x, r)
    assert _finite(got)
    assert not _finite(_repro_grads(cfg, p, x, r))
    want = _repro_grads(dataclasses.replace(cfg, ssm_chunk=REF_CHUNK), p, x, r)
    assert _finite(want) and sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL, err_msg=k)


def main() -> int:
    """One Mamba-2 layer at the published width in both packages: prints
    whether each one's gradients are finite, and how far apart they are
    where both are."""
    import time

    cfg = dataclasses.replace(jcfgs.get_config("mamba2_780m"), dtype="float32", n_layers=1)
    p, x, r = _layer(cfg, 0)
    out = {}
    for name, fn in (("repro", _repro_grads), ("port", _port_grads)):
        t0 = time.perf_counter()
        out[name] = fn(cfg, p, x, r)
        bad = sorted(k for k, g in out[name].items() if not np.isfinite(g).all())
        print(f"{name}: chunk {cfg.ssm_chunk}, {x.shape[1]} tokens, batch {x.shape[0]}, "
              f"d_model {cfg.d_model}, {cfg.ssm_heads} heads, float32: gradients "
              f"{'finite' if not bad else 'not finite in ' + ', '.join(bad)} "
              f"({time.perf_counter() - t0:.1f} s)")
    both = [k for k in out["port"] if np.isfinite(out["repro"][k]).all()
            and np.isfinite(out["port"][k]).all()]
    if both:
        err = max(float(np.abs(out["port"][k] - out["repro"][k]).max()
                        / max(np.abs(out["repro"][k]).max(), 1e-30)) for k in both)
        print(f"where both are finite ({', '.join(both)}): max difference "
              f"{err:.3g} of the largest |gradient|")
    return 0 if _finite(out["port"]) else 1


if __name__ == "__main__":
    sys.exit(main())
