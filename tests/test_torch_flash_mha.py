"""The port's flash-attention forward against the JAX package's kernel.

On the CPU the port's ``mha`` runs its plain version (dense fp32 softmax
with the kernel's counter-based dropout mask); the JAX side runs the
Pallas kernel in interpret mode, as the JAX package's own tests do. All
comparisons are fp32, atol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tchvp_tpu.kernels import flash_attention as jfa
from tchvp_tpu_torch.kernels import flash_attention as tfa
from tchvp_tpu_torch.ops import dispatch_trace

ATOL = 1e-5


def _qkv(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, dtype=np.float32) for _ in range(3)]


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 2])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_mask_is_bit_identical(seed, rate):
    for bh in (0, 5, 63):
        for s in (20, 130):
            want = np.asarray(jfa.attention_dropout_mask(seed, bh, s, s, rate))
            got = tfa.attention_dropout_mask(seed, bh, s, s, rate).numpy()
            assert got.dtype == np.bool_ and got.shape == (s, s)
            np.testing.assert_array_equal(got, want)


def test_dropout_mask_keeps_the_expected_share():
    keep = tfa.attention_dropout_mask(3, 1, 256, 256, 0.1).float().mean().item()
    assert abs(keep - 0.9) < 0.01


@pytest.mark.parametrize("shape", [(1, 2, 20, 8), (2, 2, 130, 16)])
@pytest.mark.parametrize("rate,seed", [(0.0, None), (0.1, 7)])
def test_mha_matches_jax_interpret(shape, rate, seed):
    q, k, v = _qkv(shape)
    want = jfa.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=0.3,
                   interpret=True, dropout_rate=rate, dropout_seed=seed)
    with dispatch_trace.capture() as seen:
        got = tfa.mha(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                      scale=0.3, dropout_rate=rate, dropout_seed=seed)
    assert seen == {"flash_mha_plain"}
    assert tfa.launches == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_mha_default_scale_is_inverse_sqrt_head_dim():
    q, k, v = _qkv((1, 2, 20, 8), seed=1)
    want = jfa.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True)
    got = tfa.mha(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("shape,rate,seed", [((2, 20, 8), 0.0, 0), ((4, 130, 16), 0.1, 7)])
def test_lse_matches_jax_flash_fwd(shape, rate, seed):
    q, k, v = _qkv(shape, seed=2)
    out_j, lse_j = jfa._flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  jnp.asarray([seed], jnp.int32), 0.3, 512, 2048, True, rate)
    out_t, lse_t = tfa._flash_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), 0.3, rate, seed)
    assert lse_t.dtype == torch.float32 and lse_t.shape == shape[:2]
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=ATOL, rtol=0)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=ATOL, rtol=0)


def test_mha_requires_seed_for_dropout():
    q, k, v = (torch.from_numpy(t) for t in _qkv((1, 1, 8, 4)))
    with pytest.raises(ValueError, match="dropout_seed"):
        tfa.mha(q, k, v, dropout_rate=0.1)

