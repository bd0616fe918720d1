"""The port's ``flash_attention`` against ``repro``'s, on the CPU.

On CPU tensors the port's wrapper runs its plain version,
``flash_attention_ref``; ``repro``'s Pallas kernel runs in interpret mode,
as ``tests/test_extensions.py`` runs it.  Both get the same numpy inputs.
Tolerances are ``test_extensions.py``'s: 2e-5 in float32 (the online and
the dense softmax sum in other orders), 2e-2 in bf16 against the float32
oracle (the two frameworks round bf16 at other places).  The CUDA kernel
itself is held against the plain version on the card
(``tests/test_torch_kernels_card.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.ref import flash_attention_ref as jax_flash_ref
from repro_torch.kernels._testing import FLASH_SHAPES, random_qkv
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
from repro_torch.kernels.ops import flash_attention as ops_flash

SWEEP = FLASH_SHAPES[:4]      # the four shapes of test_extensions.py


@pytest.mark.parametrize("b,lq,lk,hq,hkv,dh,causal,bq,bk", SWEEP)
def test_flash_attention_matches_repro(b, lq, lk, hq, hkv, dh, causal, bq, bk):
    q, k, v = random_qkv(b, lq, lk, hq, hkv, dh, seed=b * lq)
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                          block_q=bq, block_k=bk)
    kernel = jax_flash(*map(jnp.asarray, (q, k, v)), causal=causal, block_q=bq, block_k=bk)
    oracle = jax_flash_ref(*map(jnp.asarray, (q, k, v)), causal=causal)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(kernel), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), rtol=2e-5, atol=2e-5)


def test_flash_attention_bf16_matches_fp32_oracle():
    q, k, v = random_qkv(1, 128, 128, 4, 2, 32, seed=0)
    qb, kb, vb = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = flash_attention(qb, kb, vb, causal=True)
    assert got.dtype == torch.bfloat16
    # Both oracles see the bf16-rounded inputs, in float32.
    q32, k32, v32 = (t.float() for t in (qb, kb, vb))
    want = jax_flash_ref(*(jnp.asarray(t.numpy()) for t in (q32, k32, v32)), causal=True)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want), rtol=2e-2, atol=2e-2)
    jax_bf16 = jax_flash(*(jnp.asarray(t.numpy(), jnp.bfloat16) for t in (q32, k32, v32)),
                         causal=True)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(jax_bf16, np.float32),
                               rtol=2e-2, atol=2e-2)


def test_flash_attention_ref_matches_repro_oracle():
    q, k, v = random_qkv(2, 40, 24, 6, 3, 16, seed=7)
    for causal in (True, False):
        got = flash_attention_ref(*map(torch.from_numpy, (q, k, v)), causal=causal)
        want = jax_flash_ref(*map(jnp.asarray, (q, k, v)), causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_flash_attention_block_check_raises_in_both():
    q, k, v = random_qkv(1, 96, 96, 2, 2, 8, seed=1)
    with pytest.raises(AssertionError, match="pad seq"):
        jax_flash(*map(jnp.asarray, (q, k, v)), block_q=64, block_k=32)
    with pytest.raises(ValueError, match="pad seq"):
        flash_attention(*map(torch.from_numpy, (q, k, v)), block_q=64, block_k=32)


def test_entry_point_runs_the_plain_version_on_cpu_tensors():
    """``kernels.ops.flash_attention`` is the entry point, as in ``repro``; on
    CPU tensors it runs the plain version and counts no launch."""
    assert ops_flash is flash_attention
    q, k, v = map(torch.from_numpy, random_qkv(1, 32, 32, 4, 1, 8, seed=2))
    before = flash_attention.launches
    got = ops_flash(q, k, v, causal=False)
    assert flash_attention.launches == before
    torch.testing.assert_close(got, flash_attention_ref(q, k, v, causal=False),
                               rtol=0, atol=0)
