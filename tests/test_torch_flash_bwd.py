"""The port's flash-attention backward against the JAX package's kernels.

On the CPU the port's ``mha`` backward runs its plain version
(``mha_bwd_reference``: dense fp32 recompute of P from the saved lse with
the kernels' formulas); the JAX side is ``jax.grad`` through ``jfa.mha``
with ``interpret=True``, which runs the Pallas ``_dq_kernel`` and
``_dkv_kernel`` in interpret mode. The dropout mask is bit-exact in both,
so with dropout the gradients agree as closely as without. fp32, atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tchvp_tpu.kernels import flash_attention as jfa
from tchvp_tpu_torch.kernels import flash_attention as tfa
from tchvp_tpu_torch.ops import dispatch_trace

ATOL = 1e-5


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, dtype=np.float32) for _ in range(4)]  # q, k, v, cotangent


def _jax_grads(q, k, v, ct, scale, rate, seed):
    def f(q, k, v):
        out = jfa.mha(q, k, v, scale=scale, interpret=True, dropout_rate=rate, dropout_seed=seed)
        return jnp.sum(out * ct)

    return jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(t) for t in (q, k, v)))


def _torch_grads(q, k, v, ct, scale, rate, seed):
    qt, kt, vt = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    out = tfa.mha(qt, kt, vt, scale=scale, dropout_rate=rate, dropout_seed=seed)
    out.backward(torch.from_numpy(ct))
    return qt.grad, kt.grad, vt.grad


@pytest.mark.parametrize("shape", [(1, 2, 20, 8), (2, 2, 130, 16)])
@pytest.mark.parametrize("rate,seed", [(0.0, None), (0.1, 7)])
def test_mha_grads_match_jax_interpret(shape, rate, seed):
    q, k, v, ct = _inputs(shape)
    want = _jax_grads(q, k, v, ct, 0.3, rate, seed)
    with dispatch_trace.capture() as seen:
        got = _torch_grads(q, k, v, ct, 0.3, rate, seed)
    assert seen == {"flash_mha_plain", "flash_mha_bwd_plain"}
    assert (tfa.launches, tfa.dq_launches, tfa.dkv_launches) == (0, 0, 0)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0, err_msg=f"d{name}")


def test_seed_tensor_gives_the_int_seeds_grads():
    q, k, v, ct = _inputs((1, 2, 20, 8), seed=3)
    as_int = _torch_grads(q, k, v, ct, 0.3, 0.5, 12345)
    as_tensor = _torch_grads(q, k, v, ct, 0.3, 0.5, torch.tensor([12345], dtype=torch.int32))
    for a, b in zip(as_int, as_tensor):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_plain_backward_matches_autograd_of_the_plain_forward(rate):
    """mha_bwd_reference is the exact VJP of mha_reference (fp32)."""
    q, k, v, ct = (torch.from_numpy(t).reshape(3, 24, 8) for t in _inputs((1, 3, 24, 8), seed=5))
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    out, lse = tfa.mha_reference(qr, kr, vr, 0.25, rate, 99)
    out.backward(ct)
    delta = (ct * out.detach()).sum(-1)
    got = tfa.mha_bwd_reference(q, k, v, ct, lse.detach(), delta, 0.25, rate, 99)
    for g, w in zip(got, (qr.grad, kr.grad, vr.grad)):
        torch.testing.assert_close(g, w, rtol=0, atol=ATOL)


def test_flash_bwd_takes_delta_from_do_and_out():
    """_flash_bwd on the JAX kernels' own residuals gives their dq, dk, dv."""
    q, k, v, do = _inputs((4, 40, 16), seed=8)
    seed = jnp.asarray([3], jnp.int32)
    out_j, lse_j = jfa._flash_fwd(*(jnp.asarray(t) for t in (q, k, v)), seed, 0.3, 512, 2048, True, 0.1)
    want = jfa._flash_bwd(*(jnp.asarray(t) for t in (q, k, v)), seed, out_j, lse_j, jnp.asarray(do),
                          0.3, 512, 2048, True, 0.1)
    out, lse = (torch.from_numpy(np.array(t)) for t in (out_j, lse_j))
    dot = torch.from_numpy(do)
    got = tfa._flash_bwd(*(torch.from_numpy(t) for t in (q, k, v)), dot, lse,
                         (dot * out).sum(-1), 0.3, 0.1, 3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)


def test_bf16_grads_come_back_in_bf16():
    q, k, v, ct = (torch.from_numpy(t).to(torch.bfloat16) for t in _inputs((1, 1, 16, 8), seed=9))
    qt, kt, vt = (t.clone().requires_grad_() for t in (q, k, v))
    tfa.mha(qt, kt, vt).backward(ct)
    assert all(t.grad.dtype == torch.bfloat16 and t.grad.shape == (1, 1, 16, 8) for t in (qt, kt, vt))
