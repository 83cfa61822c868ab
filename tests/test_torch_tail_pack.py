"""The fused tail kernel's packed weights and its bf16 rounding, on the CPU.

The kernel (``csrc/fused_tail.cu``) reads the folded weights as
``pack_tail_weights`` lays them out (rows of output columns, K contiguous,
rounded to the input dtype), and in bf16 stores u rounded to bf16 in shared
memory (a0 and a1 in fp32). ``tail_chain`` computes the same function
plainly from the packed arrays.

* The packing through ``tail_chain``: against JAX's ``fused_decoder_tail``
  with ``tile=16, interpret=True`` (the Pallas kernel in interpret mode, or
  its reference for a shape 16 does not tile), the decoder's widths, both
  heads and a ragged shape, the same numpy inputs; rtol/atol 2e-4, the JAX
  tests' own.
* The wrapper's ``_kernel_weights`` is ``pack_tail_weights`` in x's dtype,
  element for element the folded weights in the documented layouts, 16-byte
  aligned.
* The bf16-rounding budget: ``tail_chain`` with u rounded to bf16, as the
  kernel stores it, and with u, a0 and a1 rounded, as the TPU kernel stores
  them, lies within 1e-2 x max|ref| of the fp32 chain on the same
  bf16-rounded inputs and weights, at phase 5b's three small shapes and
  seeds (``chip_smoke.TAIL_SHAPES``; measured at most 2.1e-3 and 4.0e-3), so
  phase 5b's bf16 limit of 2e-2 keeps its margin. (On the decoder path's
  bodies the three rounded read 2.45e-2 from the fp32 chain on the card,
  over that path's 2e-2 limit; u alone 1.61e-2: why the kernel keeps a0
  and a1 in fp32.)
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import TAIL_SHAPES, seed_decoder
from tchvp_tpu.kernels import fused_tail as jft
from tchvp_tpu_torch.kernels import fused_tail as tft
from tchvp_tpu_torch.models.resnet_ae import Decoder32K
from tchvp_tpu_torch.ops.blocks import init_flax_default
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


def _folded(rng, c4):
    """Folded weights at the decoder's widths, scaled by 1/sqrt(fan-in) so
    that every stage stays of order one."""
    def mk(fan, *shape):
        return rng.normal(0, fan ** -0.5, shape).astype(np.float32)

    cin, c1, c2, c3 = tft.CIN, tft.C1, tft.C2, tft.C3
    b_up = mk(4, c1)
    return dict(w_up=mk(cin, cin, 4 * c1), b_up=b_up, b_up4=np.tile(b_up, 4), w0=mk(9 * c1, 3, 3, c1, c2),
                b0=mk(4, c2), w1=mk(9 * c2, 3, 3, c2, c3), b1=mk(4, c3), w2=mk(9 * c3, 3, 3, c3, c4),
                b2=mk(4, c4))


@pytest.mark.parametrize("shape,output_type,seed", [
    ((1, 8, 8), "image", 21),    # one 16x16 tile
    ((1, 8, 16), "mask", 22),    # two tiles, the sigmoid head
    ((2, 9, 9), "image", 23),    # 2H not a tile multiple: JAX takes its reference
    ((1, 9, 7), "mask", 24),
], ids=["one_tile", "two_tiles_mask", "ragged_9x9", "ragged_9x7_mask"])
def test_packed_chain_matches_jax_interpret(shape, output_type, seed):
    rng = np.random.default_rng(seed)
    folded = _folded(rng, 1 if output_type == "mask" else 3)
    x = rng.standard_normal(shape + (tft.CIN,), dtype=np.float32)
    want = jft.fused_decoder_tail(jnp.asarray(x), {k: jnp.asarray(v) for k, v in folded.items()},
                                  output_type=output_type, tile=16, interpret=True)
    packed = tft.pack_tail_weights({k: torch.from_numpy(v) for k, v in folded.items()}, torch.float32)
    with torch.no_grad():
        got = tft.tail_chain(torch.from_numpy(x), packed, output_type)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_kernel_weights_are_the_packed_layouts(dtype):
    folded = {k: torch.from_numpy(v) for k, v in _folded(np.random.default_rng(25), 3).items()}
    x = torch.zeros(1, 2, 2, tft.CIN, dtype=dtype)
    got = tft._kernel_weights(x, folded)
    want = tft.pack_tail_weights(folded, dtype)
    assert sorted(got) == sorted(want) == ["b0", "b1", "b2", "b_up", "w0", "w1", "w2", "w_up"]
    for name, t in got.items():
        assert torch.equal(t, want[name]) and t.is_contiguous() and t.data_ptr() % 16 == 0, name
    r = {k: v.to(dtype) for k, v in folded.items()}
    assert got["w_up"].dtype == got["w0"].dtype == got["w1"].dtype == dtype
    assert got["w_up"].shape == (4 * tft.C1, tft.CIN) and torch.equal(got["w_up"], r["w_up"].t())
    for dy, dx, o, c in ((0, 0, 0, 0), (1, 2, 63, 191), (2, 1, 17, 100)):
        assert got["w0"][3 * dy + dx, o, c] == r["w0"][dy, dx, c, o]
    for dy, dx, o, c in ((0, 0, 0, 0), (2, 2, 7, 63), (1, 0, 3, 40)):
        assert got["w1"][o, (3 * dy + dx) * tft.C2 + c] == r["w1"][dy, dx, c, o]
    for name in ("b_up", "b0", "b1", "w2", "b2"):
        assert got[name].dtype == torch.float32 and torch.equal(got[name], r[name].float()), name


@pytest.fixture(scope="module", params=["image", "mask"])
def phase5b_folded(request):
    """Phase 5b's folded weights of one head, as chip_smoke.py makes them."""
    h_i = ("image", "mask").index(request.param)
    decoder = Decoder32K(output_type=request.param)
    init_flax_default(decoder, torch.Generator().manual_seed(h_i))
    return request.param, tft.fold_tail_params(seed_decoder(decoder, 10 + h_i).eval())


@pytest.mark.parametrize("stages", [("u",), ("u", "a0", "a1")], ids=["kernel", "tpu_kernel"])
@pytest.mark.parametrize("case", range(3), ids=[str(s) for s in TAIL_SHAPES[:3]])
def test_bf16_rounding_budget(phase5b_folded, case, stages):
    output_type, folded = phase5b_folded
    b, h, w = TAIL_SHAPES[case]
    x = torch.from_numpy(np.random.default_rng(80 + case).standard_normal((b, h, w, tft.CIN), dtype=np.float32))
    x = x.bfloat16().float()
    with torch.no_grad():
        ref = tft.fused_tail_reference(x, {k: v.bfloat16().float() for k, v in folded.items()}, output_type)
        rounded = tft.tail_chain(x, tft.pack_tail_weights(folded, torch.bfloat16), output_type,
                                 round_to=torch.bfloat16, stages=stages)
    scale = ref.abs().max().item()
    assert rounded.shape == ref.shape == (b, 2 * h, 2 * w, 1 if output_type == "mask" else 3)
    assert (rounded - ref).abs().max().item() <= 1e-2 * scale
