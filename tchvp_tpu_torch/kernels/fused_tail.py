"""Fused decoder tail: the Hopper kernel, its plain version and the BN fold.

Counterpart of ``tchvp_tpu/kernels/fused_tail.py``. ``Decoder32K.tail`` in
eval mode is ConvTranspose 2x2/s2 384->192 + BN + ReLU, then 3x3 convs
192->64 and 64->8, each + BN + ReLU, then a 3x3 head 8->3|1 + BN with a
ReLU (image) or sigmoid (mask). :func:`fold_tail_params` folds the eval BNs
into the weights and returns the JAX package's dict, key for key and layout
for layout. On a CUDA tensor :func:`fused_decoder_tail` launches the
hand-written kernel ``csrc/fused_tail.cu`` (built at first use by
:mod:`.build`; every product on the tensor cores), which reads the
384-channel half-resolution input once and writes only the 3- or 1-channel
output; the wrapper hands it the folded weights as
:func:`pack_tail_weights` lays them out, once per call. On a CPU tensor it
runs :func:`fused_tail_reference`, the plain fp32 chain (:func:`tail_chain`
on the packed fp32 weights). A CUDA tensor never reaches the plain version,
and a build or launch failure raises.

Inference only, and off the default inference path, as in the JAX package:
``Decoder32K.forward`` keeps the cuDNN chain.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from tchvp_tpu_torch.ops.blocks import polyphase_weight

# Launches of the CUDA kernel in this process (never the plain version);
# chip_smoke.py resets it around the paths it drives.
launches = 0

# The decoder's widths, the only ones the kernel is built for: input, the
# up-projection, the two 3x3 convs; the head has 3 (image) or 1 (mask).
CIN, C1, C2, C3 = 384, 192, 64, 8
HEADS = (3, 1)


def _bn_scale_shift(bn: torch.nn.BatchNorm2d, eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval BN as y = x * s + t, fp32: s = gamma / sqrt(var + eps), t = beta - mean * s."""
    s = bn.weight.float() / torch.sqrt(bn.running_var.float() + eps)
    return s, bn.bias.float() - bn.running_mean.float() * s


def _hwio(weight: torch.Tensor) -> torch.Tensor:
    """A conv weight OIHW -> HWIO, fp32."""
    return weight.float().permute(2, 3, 1, 0)


@torch.no_grad()
def fold_tail_params(decoder: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """Fold the eval-mode BNs of ``decoder.tail`` (the port's
    ``Decoder32K``) into its conv weights: the JAX ``fold_tail_params``
    dict, fp32 on the decoder's device. ``w_up`` (Cin, 4*C1) has columns in
    (di, dj, c) order, ``b_up4`` is ``b_up`` tiled 4 times, ``w0``/``w1``/
    ``w2`` are HWIO scaled per output channel."""
    s_up, t_up = _bn_scale_shift(decoder.up_bns[1])
    up = decoder.upconvs[1]
    # torch's ConvTranspose2d weight already carries flax's spatial flip
    # (convert.py), so the polyphase matrix takes it as it is.
    w_up = polyphase_weight(up.weight.float() * s_up[None, :, None, None])
    b_up = up.bias.float() * s_up + t_up
    s0, t0 = _bn_scale_shift(decoder.post_bns[0])
    s1, t1 = _bn_scale_shift(decoder.post_bns[1])
    s2, t2 = _bn_scale_shift(decoder.head_bn)
    folded = dict(
        w_up=w_up,
        b_up=b_up,
        b_up4=b_up.repeat(4),
        w0=_hwio(decoder.post_convs[0].weight) * s0,
        b0=t0,
        w1=_hwio(decoder.post_convs[1].weight) * s1,
        b1=t1,
        w2=_hwio(decoder.head_conv.weight) * s2,
        b2=decoder.head_conv.bias.float() * s2 + t2,
    )
    return {k: v.contiguous() for k, v in folded.items()}


def _conv3x3(v: torch.Tensor, w_oihw: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """SAME 3x3 conv of NCHW ``v`` with an OIHW weight, fp32."""
    return F.conv2d(v, w_oihw.float(), bias.float(), padding=1)


@torch.no_grad()
def pack_tail_weights(folded: Dict[str, torch.Tensor], dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The folded weights as the kernel reads them, each value rounded to
    ``dtype`` as the TPU kernel casts them. The products' weights are in
    ``dtype``, one row per output column with K contiguous, so that the
    kernel's B fragments load without a transpose: ``w_up`` (4*C1, Cin),
    the folded w_up transposed (rows (di, dj, c)); ``w0`` (9, C2, C1) and
    ``w1`` (C3, 9*C2), per tap output channel by input channel. The head
    ``w2`` (3, 3, C3, C4) and the biases ``b_up``, ``b0``, ``b1``, ``b2``
    are fp32. Any widths; the kernel takes the decoder's
    (:func:`fused_tail_cuda` checks them)."""
    def rounded(name):
        return folded[name].to(dtype)

    c2, c1 = folded["w0"].shape[3], folded["w0"].shape[2]
    c3 = folded["w1"].shape[3]
    packed = dict(
        w_up=rounded("w_up").t(),
        w0=rounded("w0").reshape(9, c1, c2).transpose(1, 2),
        w1=rounded("w1").reshape(9, c2, c3).permute(2, 0, 1).reshape(c3, 9 * c2),
    )
    for name in ("b_up", "b0", "b1", "w2", "b2"):
        packed[name] = rounded(name).float()
    return {k: v.contiguous() for k, v in packed.items()}


def tail_chain(x: torch.Tensor, packed: Dict[str, torch.Tensor], output_type: str = "image",
               round_to: Optional[torch.dtype] = None, stages: Sequence[str] = ("u",)) -> torch.Tensor:
    """The kernel's function computed plainly from :func:`pack_tail_weights`'
    arrays: x (B, H, W, Cin) -> (B, 2H, 2W, C4) in x's dtype, fp32
    products: (x @ w_up) then depth-to-space, ReLU, three SAME 3x3 convs,
    and a ReLU or sigmoid head. ``round_to`` rounds the intermediates named
    in ``stages`` ("u", "a0", "a1") to that dtype: the kernel rounds u for
    bf16 inputs (the default), the TPU kernel all three. The
    full-resolution intermediates are updated in place (each is a new
    tensor), which keeps the peak at two of them."""
    b, h, w, _ = x.shape
    c1 = packed["b_up"].shape[0]
    c2, c3 = packed["b0"].shape[0], packed["b1"].shape[0]

    def stored(v, stage):
        return v if round_to is None or stage not in stages else v.copy_(v.to(round_to))

    y = x.float() @ packed["w_up"].float().t()  # (B, H, W, 4*C1), columns (di, dj, c)
    y = y.reshape(b, h, w, 2, 2, c1).permute(0, 5, 1, 3, 2, 4).reshape(b, c1, 2 * h, 2 * w)
    y = stored(y.add_(packed["b_up"][:, None, None]).relu_(), "u")
    w0 = packed["w0"].reshape(3, 3, c2, c1).permute(2, 3, 0, 1)
    y = stored(_conv3x3(y, w0, packed["b0"]).relu_(), "a0")
    w1 = packed["w1"].reshape(c3, 3, 3, c2).permute(0, 3, 1, 2)
    y = stored(_conv3x3(y, w1, packed["b1"]).relu_(), "a1")
    y = _conv3x3(y, packed["w2"].permute(3, 2, 0, 1), packed["b2"])
    y = torch.sigmoid(y) if output_type == "mask" else torch.relu(y)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def fused_tail_reference(x: torch.Tensor, folded: Dict[str, torch.Tensor],
                         output_type: str = "image") -> torch.Tensor:
    """Plain version of the kernel: x (B, H, W, Cin) -> (B, 2H, 2W, C4) in
    x's dtype, fp32 throughout (:func:`tail_chain` on the folded weights as
    they are)."""
    return tail_chain(x, pack_tail_weights(folded, torch.float32), output_type)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C launcher's arguments on a library built from
    ``csrc/fused_tail.cu``: x, out, 8 weights; B, H, W and x's 4 strides;
    C4, sigmoid, is_bf16; the stream."""
    lib.tchvp_fused_tail.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int64] * 7
                                     + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.tchvp_fused_tail.restype = ctypes.c_int
    lib.tchvp_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tchvp_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _kernel_lib() -> ctypes.CDLL:
    """Build (once) and bind ``csrc/fused_tail.cu``'s C launcher."""
    from tchvp_tpu_torch.kernels import build

    lib = build.load("fused_tail", ["fused_tail.cu"])
    if lib.tchvp_cuda_error_string.restype is not ctypes.c_char_p:
        bind(lib)
    return lib


_SHAPES = {"w_up": (CIN, 4 * C1), "b_up": (C1,), "w0": (3, 3, C1, C2), "b0": (C2,),
           "w1": (3, 3, C2, C3), "b1": (C3,)}


def _kernel_weights(x: torch.Tensor, folded: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The packed weights the kernel reads (:func:`pack_tail_weights` in
    x's dtype), checked first against the decoder's widths, on x's device,
    16-byte aligned (the kernel copies them in 16-byte pieces)."""
    c4 = folded["b2"].shape[0] if folded["b2"].dim() == 1 else -1
    shapes = dict(_SHAPES, w2=(3, 3, C3, c4), b2=(c4,))
    if c4 not in HEADS:
        raise ValueError(f"the fused tail kernel takes a head of {HEADS} channels, got b2 "
                         f"{tuple(folded['b2'].shape)}")
    for name, shape in shapes.items():
        if tuple(folded[name].shape) != shape:
            raise ValueError(f"the fused tail kernel takes the decoder's widths: {name} must be "
                             f"{shape}, got {tuple(folded[name].shape)}")
    packed = pack_tail_weights({k: folded[k].to(x.device) for k in shapes}, x.dtype)
    return {k: t if t.data_ptr() % 16 == 0 else t.clone() for k, t in packed.items()}


def fused_tail_cuda(x: torch.Tensor, folded: Dict[str, torch.Tensor],
                    output_type: str = "image") -> torch.Tensor:
    """Launch ``csrc/fused_tail.cu`` on the current stream: x (B, H, W, 384)
    fp32 or bf16, any strides (an NHWC view of an NCHW tensor needs no
    copy), any H, W >= 1 -> a new contiguous (B, 2H, 2W, C4). In bf16 the
    kernel rounds u to bf16 and keeps a0 and a1 in fp32
    (``tail_chain(..., round_to=torch.bfloat16)`` computes that plainly)."""
    global launches
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the fused tail kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or x.shape[3] != CIN or min(x.shape[:3]) < 1:
        raise ValueError(f"the fused tail kernel takes (B, H, W, {CIN}) with B, H, W >= 1, "
                         f"got {tuple(x.shape)}")
    if output_type not in ("image", "mask"):
        raise ValueError(f"output_type must be 'image' or 'mask', got {output_type!r}")
    w = _kernel_weights(x, folded)
    if not x.is_cuda:
        raise ValueError(f"the fused tail kernel takes a CUDA tensor, got one on {x.device}")
    b, h, wd, _ = x.shape
    c4 = w["b2"].shape[0]
    out = torch.empty((b, 2 * h, 2 * wd, c4), dtype=x.dtype, device=x.device)
    lib = _kernel_lib()
    with torch.cuda.device(x.device):
        err = lib.tchvp_fused_tail(
            x.data_ptr(), out.data_ptr(),
            *(w[k].data_ptr() for k in ("w_up", "b_up", "w0", "b0", "w1", "b1", "w2", "b2")),
            b, h, wd, *x.stride(), c4, int(output_type == "mask"), int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        msg = lib.tchvp_cuda_error_string(err).decode()
        raise RuntimeError(f"fused_tail launch failed: {msg} (cudaError {err})")
    launches += 1
    return out


def fused_decoder_tail(x: torch.Tensor, folded: Dict[str, torch.Tensor],
                       output_type: str = "image") -> torch.Tensor:
    """x: (B, H, W, 384) NHWC -> (B, 2H, 2W, 3|1) NHWC: ``Decoder32K.tail``
    in eval mode with the BNs folded in (:func:`fold_tail_params`). The
    kernel on a CUDA tensor, the plain version on a CPU one."""
    if x.is_cuda:
        return fused_tail_cuda(x, folded, output_type)
    return fused_tail_reference(x, folded, output_type)
