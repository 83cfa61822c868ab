"""The port's halo attention (one shard of sequence-parallel windowed
attention) against the JAX package's ``windowed_mha_halo``.

On the CPU the port runs the halo kernels' plain versions through
``_HaloAttention`` (dense fp32 over the (S, S + w) logits with the halo band
masked); JAX runs the Pallas halo kernels in interpret mode, and
``jax.grad`` their backward. Forward atol 1e-5 and the three gradients
(dq, dk_ext, dv_ext, the halo window's included) atol 1e-4, as
``tests/test_kernels.py`` holds the Pallas kernels, for ``has_prev`` 0 and
1, without and with dropout: the hash mask is bit-exact in both, the
negative halo columns included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tchvp_tpu.kernels import flash_attention as jfa
from tchvp_tpu_torch.kernels import flash_attention as tfa
from tchvp_tpu_torch.ops import dispatch_trace
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

FWD_ATOL, GRAD_ATOL = 1e-5, 1e-4


def _arrays(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, dtype=np.float32) for shape in shapes]


def _inputs(b, h, s, dh, w, seed):
    """q, k_ext, v_ext and an output cotangent."""
    return _arrays([(b, h, s, dh), (b, h, s + w, dh), (b, h, s + w, dh), (b, h, s, dh)], seed)


def _jax_halo(q, ke, ve, ct, w, has_prev, rate, seed):
    def f(q, ke, ve):
        out = jfa.windowed_mha_halo(q, ke, ve, window_size=w, has_prev=has_prev, scale=0.3,
                                    interpret=True, dropout_rate=rate, dropout_seed=seed)
        return jnp.sum(out * ct), out

    (_, out), grads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(t) for t in (q, ke, ve)))
    return out, grads


def _torch_halo(q, ke, ve, ct, w, has_prev, rate, seed):
    qt, kt, vt = (torch.from_numpy(t).requires_grad_() for t in (q, ke, ve))
    out = tfa.windowed_mha_halo(qt, kt, vt, window_size=w, has_prev=has_prev, scale=0.3,
                                dropout_rate=rate, dropout_seed=seed)
    out.backward(torch.from_numpy(ct))
    return out.detach(), (qt.grad, kt.grad, vt.grad)


@pytest.mark.parametrize("s", [64, 80])  # 4 and 5 windows of 16
@pytest.mark.parametrize("has_prev", [0, 1])
@pytest.mark.parametrize("rate,seed", [(0.0, None), (0.2, 7)])
def test_windowed_mha_halo_matches_jax_interpret(s, has_prev, rate, seed):
    b, h, dh, w = 2, 2, 8, 16
    q, ke, ve, ct = _inputs(b, h, s, dh, w, seed=s + has_prev)
    want_out, want_grads = _jax_halo(q, ke, ve, ct, w, has_prev, rate, seed)
    with dispatch_trace.capture() as seen:
        out, grads = _torch_halo(q, ke, ve, ct, w, has_prev, rate, seed)
    assert seen == {"flash_halo_plain", "flash_halo_bwd_plain"}
    assert (tfa.halo_fwd_launches, tfa.halo_dq_launches, tfa.halo_dkv_launches) == (0, 0, 0)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=FWD_ATOL, rtol=0)
    for name, g, want in zip(("dq", "dk_ext", "dv_ext"), grads, want_grads):
        assert g.shape == want.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(want), atol=GRAD_ATOL, rtol=0, err_msg=name)
    # has_prev 0: the halo window gets no gradient at all.
    if has_prev == 0:
        assert not grads[1][:, :, :w].any() and not grads[2][:, :, :w].any()


@pytest.mark.parametrize("rate,seed", [(0.0, None), (0.2, 3)])
def test_no_prev_equals_windowed_mha_on_the_local_sequence(rate, seed):
    b, h, s, dh, w = 2, 2, 64, 8, 16
    q, k, v, ct = (torch.from_numpy(t) for t in _arrays([(b, h, s, dh)] * 4, seed=1))
    halo = torch.from_numpy(_arrays([(b, h, w, dh)], seed=2)[0])  # masked: any values
    qh, kh, vh = (t.clone().requires_grad_() for t in (q, torch.cat([halo, k], 2), torch.cat([halo, v], 2)))
    out_h = tfa.windowed_mha_halo(qh, kh, vh, window_size=w, has_prev=torch.tensor([0]),
                                  dropout_rate=rate, dropout_seed=seed)
    out_h.backward(ct)
    qw, kw, vw = (t.clone().requires_grad_() for t in (q, k, v))
    out_w = tfa.windowed_mha(qw, kw, vw, window_size=w, dropout_rate=rate, dropout_seed=seed)
    out_w.backward(ct)
    torch.testing.assert_close(out_h, out_w, atol=FWD_ATOL, rtol=0)
    for g_h, g_w in ((qh.grad, qw.grad), (kh.grad[:, :, w:], kw.grad), (vh.grad[:, :, w:], vw.grad)):
        torch.testing.assert_close(g_h, g_w, atol=GRAD_ATOL, rtol=0)


@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_halo_plain_backward_is_the_vjp_of_its_forward(rate):
    q, ke, ve, ct = (torch.from_numpy(t).reshape(t.shape[1:]) for t in _inputs(1, 3, 48, 8, 16, seed=8))
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, ke, ve))
    out, lse = tfa.windowed_mha_halo_reference(qr, kr, vr, 0.25, 16, 1, rate, 99)
    out.backward(ct)
    delta = (ct * out.detach()).sum(-1)
    args = (q, ke, ve, ct, lse.detach(), delta, 0.25, 16, 1, rate, 99)
    got = (tfa.windowed_mha_halo_bwd_dq_reference(*args),) + tfa.windowed_mha_halo_bwd_dkv_reference(*args)
    for g, w in zip(got, (qr.grad, kr.grad, vr.grad)):
        torch.testing.assert_close(g, w, rtol=0, atol=FWD_ATOL)


@pytest.mark.parametrize("has_prev", [0, 1])
def test_halo_band_mask_is_the_tpu_kernels_halo_band(has_prev):
    want = np.asarray(jfa._halo_band_mask((48, 64), 0, 0, 16, 48, jnp.asarray(has_prev == 0)))
    got = tfa.halo_band_mask(48, 16, torch.tensor([has_prev], dtype=torch.int32), torch.device("cpu"))
    np.testing.assert_array_equal(got.numpy(), want)


def test_negative_halo_columns_hash_as_the_tpu_kernels():
    """The halo window's columns are -w..-1: JAX casts int32 to uint32,
    the port masks its int64 to 32 bits before the hash."""
    seed, bh, s, w, rate = 12345, 3, 32, 16, 0.5
    want = jfa._keep_mask(jnp.int32(seed), jnp.int32(bh), 0, -w, (s, s + w), rate)
    got = tfa._keep_mask(seed, torch.tensor(bh), s, s + w, rate, col0=-w)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # The local columns are the unsharded mask's own.
    np.testing.assert_array_equal(got[:, w:].numpy(),
                                  tfa.attention_dropout_mask(seed, bh, s, s, rate).numpy())


def test_windowed_mha_halo_rejects_bad_arguments_and_keeps_bf16():
    q = torch.zeros(1, 1, 16, 8, dtype=torch.bfloat16, requires_grad=True)
    ke = torch.zeros(1, 1, 20, 8, dtype=torch.bfloat16, requires_grad=True)
    with pytest.raises(ValueError, match="window_size"):
        tfa.windowed_mha_halo(q, ke, ke, window_size=0, has_prev=1)
    with pytest.raises(ValueError, match="S % window"):
        tfa.windowed_mha_halo(q, ke[:, :, :19], ke[:, :, :19], window_size=3, has_prev=1)
    with pytest.raises(ValueError, match="dropout_seed"):
        tfa.windowed_mha_halo(q, ke, ke, window_size=4, has_prev=1, dropout_rate=0.1)
    tfa.windowed_mha_halo(q, ke, ke, window_size=4, has_prev=True).sum().backward()
    assert q.grad.dtype == torch.bfloat16 and ke.grad.shape == (1, 1, 20, 8)
