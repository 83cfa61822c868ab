"""Import reference PyTorch checkpoints into the port.

The port's own copy of ``tchvp_tpu/utils/torch_port.py`` (numpy only, as
there): a reference ``torch.save`` file (a full training-state dict with
its ``model_state_dict``, or a bare state_dict) is converted into the flax
``{"params", "batch_stats"}`` layout of the JAX package's model families,
which ``convert.from_flax`` then maps into the port's ``state_dict``
(:func:`import_reference`). Going through the flax layout keeps one set of
layout rules for both packages:

* conv OIHW -> HWIO; transposed-conv (in,out,kh,kw) -> (kh,kw,in,out)
  spatially flipped (flax ConvTranspose convention);
* linear (out,in) -> (in,out);
* the AE squeeze/decoder convs carry biases the BN-following convs omit
  as redundant: the bias FOLDS into the BatchNorm running mean
  (BN(conv(x)+b) == BN'(conv(x)) with mean' = mean - b), exactly;
* ``nn.MultiheadAttention``'s packed in_proj splits into q/k/v kernels.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from tchvp_tpu_torch.convert import from_flax


def _np(t) -> np.ndarray:
    """torch.Tensor | np.ndarray -> numpy."""
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t)


def load_reference_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """Load a reference ``torch.save`` file -> flat name->array dict.

    Handles both formats: the full training-state dict (uses its
    ``model_state_dict`` entry, FCT.py:368-373) and a bare state_dict
    (Model.py:182). ``weights_only=True`` keeps untrusted pickles out.
    """
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "model_state_dict" in obj:
        obj = obj["model_state_dict"]
    return {k: _np(v) for k, v in obj.items()}


def _conv(sd, name: str, bias: bool = True) -> Dict[str, np.ndarray]:
    out = {"kernel": np.transpose(_np(sd[f"{name}.weight"]), (2, 3, 1, 0))}
    if bias and f"{name}.bias" in sd:
        out["bias"] = _np(sd[f"{name}.bias"])
    return out


def _upconv(sd, name: str) -> Dict[str, np.ndarray]:
    w = np.transpose(_np(sd[f"{name}.weight"]), (2, 3, 0, 1))[::-1, ::-1]
    return {"kernel": np.ascontiguousarray(w), "bias": _np(sd[f"{name}.bias"])}


def _linear(sd, name: str) -> Dict[str, np.ndarray]:
    return {
        "kernel": np.ascontiguousarray(_np(sd[f"{name}.weight"]).T),
        "bias": _np(sd[f"{name}.bias"]),
    }


def _ln(sd, name: str) -> Dict[str, np.ndarray]:
    return {"scale": _np(sd[f"{name}.weight"]), "bias": _np(sd[f"{name}.bias"])}


def _bn(
    sd, name: str, fold_bias_of: Optional[str] = None
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """BatchNorm -> (params, batch_stats) in our BatchNorm wrapper layout.
    ``fold_bias_of``: name of the preceding conv whose (BN-redundant)
    bias folds into the running mean."""
    mean = _np(sd[f"{name}.running_mean"]).copy()
    if fold_bias_of is not None and f"{fold_bias_of}.bias" in sd:
        mean = mean - _np(sd[f"{fold_bias_of}.bias"])
    p = {"BatchNorm_0": {"scale": _np(sd[f"{name}.weight"]),
                         "bias": _np(sd[f"{name}.bias"])}}
    s = {"BatchNorm_0": {"mean": mean, "var": _np(sd[f"{name}.running_var"])}}
    return p, s


def num_attention_layers(sd) -> int:
    """Layer count of a TransformerEncoder state_dict (for importers
    that must infer the architecture from the checkpoint alone)."""
    idx = [
        int(k.split(".")[1]) for k in sd if k.startswith("attention_layers.")
    ]
    if not idx:
        raise ValueError(
            "state_dict has no attention_layers.* keys — not a "
            "TransformerEncoder checkpoint"
        )
    return 1 + max(idx)


def import_unet(sd) -> Dict[str, Any]:
    """UNet.py / segmentationUNet state_dict -> flax variables."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    blocks = [("encoder1", "enc1"), ("encoder2", "enc2"), ("encoder3", "enc3"),
              ("encoder4", "enc4"), ("bottleneck", "bottleneck"),
              ("decoder4", "dec4"), ("decoder3", "dec3"),
              ("decoder2", "dec2"), ("decoder1", "dec1")]
    for fname, pre in blocks:
        bp: Dict[str, Any] = {}
        bs: Dict[str, Any] = {}
        for i in (1, 2):
            bp[f"conv{i}"] = _conv(sd, f"{fname}.{pre}conv{i}", bias=False)
            bp[f"norm{i}"], bs[f"norm{i}"] = _bn(sd, f"{fname}.{pre}norm{i}")
        params[fname], stats[fname] = bp, bs
    for i in (1, 2, 3, 4):
        params[f"upconv{i}"] = _upconv(sd, f"upconv{i}")
    params["conv"] = _conv(sd, "conv")
    return {"params": params, "batch_stats": stats}


def import_transformer_encoder(sd, num_layers: int) -> Dict[str, Any]:
    """Recovered TransformerEncoder state_dict -> flax params (the shared
    per-layer LayerNorm maps to our single ``norm_{l}``)."""
    params: Dict[str, Any] = {}
    for layer in range(num_layers):
        params[f"attention_{layer}"] = {
            "q_linear": _linear(sd, f"attention_layers.{layer}.query_layer"),
            "k_linear": _linear(sd, f"attention_layers.{layer}.key_layer"),
            "v_linear": _linear(sd, f"attention_layers.{layer}.value_layer"),
            "out_linear": _linear(sd, f"attention_layers.{layer}.output_layer"),
        }
        params[f"ffn1_{layer}"] = _linear(sd, f"feedforward_layers.{layer}.0")
        params[f"ffn2_{layer}"] = _linear(sd, f"feedforward_layers.{layer}.2")
        params[f"norm_{layer}"] = _ln(sd, f"layer_norm.{layer}")
    return {"params": params}


def _import_resnet_encoder(sd, prefix: str, n_squeeze: int,
                           layers: Tuple[int, ...]):
    p: Dict[str, Any] = {"stem_conv": _conv(sd, f"{prefix}.conv1", bias=False)}
    s: Dict[str, Any] = {}
    p["stem_bn"], s["stem_bn"] = _bn(sd, f"{prefix}.bn1",
                                     fold_bias_of=f"{prefix}.conv1")
    for li, blocks in enumerate(layers, start=1):
        for j in range(blocks):
            t = f"{prefix}.layer{li}.{j}"
            bp: Dict[str, Any] = {}
            bs: Dict[str, Any] = {}
            for n in ("conv1", "conv2", "conv3"):
                bp[n] = _conv(sd, f"{t}.{n}", bias=False)
            for n in ("bn1", "bn2", "bn3"):
                bp[n], bs[n] = _bn(sd, f"{t}.{n}",
                                   fold_bias_of=f"{t}.conv{n[-1]}")
            if f"{t}.downsample.0.weight" in sd:
                bp["downsample_conv"] = _conv(sd, f"{t}.downsample.0", bias=False)
                bp["downsample_bn"], bs["downsample_bn"] = _bn(
                    sd, f"{t}.downsample.1", fold_bias_of=f"{t}.downsample.0"
                )
            p[f"layer{li}_block{j}"], s[f"layer{li}_block{j}"] = bp, bs
    for i in range(n_squeeze):
        t = f"{prefix}.conv{i + 2}"
        p[f"squeeze{i}_conv"] = _conv(sd, t, bias=False)
        p[f"squeeze{i}_bn"], s[f"squeeze{i}_bn"] = _bn(
            sd, f"{prefix}.bn{i + 2}", fold_bias_of=t
        )
    return p, s


def _import_resnet_decoder(sd, prefix: str):
    p: Dict[str, Any] = {}
    s: Dict[str, Any] = {}
    for i in range(4):
        t = f"{prefix}.conv{i + 1}"
        p[f"conv{i}"] = _conv(sd, t, bias=False)
        p[f"bn{i}"], s[f"bn{i}"] = _bn(sd, f"{prefix}.bn{i + 1}", fold_bias_of=t)
    for i, (tc, tb) in enumerate((("transConv1", "dbn2"), ("transConv2", "dbn3"))):
        p[f"upconv{i}"] = _upconv(sd, f"{prefix}.{tc}")
        p[f"up_bn{i}"], s[f"up_bn{i}"] = _bn(sd, f"{prefix}.{tb}")
    for i, (cn, bn_) in enumerate((("conv5", "bn5"), ("conv6", "bn6"))):
        t = f"{prefix}.{cn}"
        p[f"post_conv{i}"] = _conv(sd, t, bias=False)
        p[f"post_bn{i}"], s[f"post_bn{i}"] = _bn(sd, f"{prefix}.{bn_}",
                                                 fold_bias_of=t)
    p["head_conv"] = _conv(sd, f"{prefix}.outputDeterminerConv")
    p["head_bn"], s["head_bn"] = _bn(sd, f"{prefix}.outputDeterminerNorm")
    return p, s


def import_autoencoder32k(sd, layers: Tuple[int, ...] = (3, 4)) -> Dict[str, Any]:
    """AE_32K / AE_256_32K checkpoint -> flax Autoencoder32K variables
    (identical parameters in both — verified state-dict to state-dict)."""
    ep, es = _import_resnet_encoder(sd, "encoder", n_squeeze=4, layers=layers)
    dp, ds = _import_resnet_decoder(sd, "decoder")
    return {"params": {"encoder": ep, "decoder": dp},
            "batch_stats": {"encoder": es, "decoder": ds}}


def import_autoencoder4k(sd, layers: Tuple[int, ...] = (3, 4)) -> Dict[str, Any]:
    """AE_64_4k checkpoint -> flax Autoencoder4K variables (same module
    names as AE_32K; four squeeze stages, decoder opens at 32)."""
    return import_autoencoder32k(sd, layers=layers)


def import_video_hybrid(ae_sd, temporal_sd, num_layers: int = 1) -> Dict[str, Any]:
    """Compose the flagship VideoHybridNet variables from a frame-AE
    checkpoint (AE_256_32K) and a temporal-transformer checkpoint — the
    reference's cross-stage transfer pattern (AE_32K L233-245) applied to
    the video pipeline."""
    ae = import_autoencoder32k(ae_sd)
    tr = import_transformer_encoder(temporal_sd, num_layers)
    return {
        "params": {
            "encoder": ae["params"]["encoder"],
            "decoder": ae["params"]["decoder"],
            "temporal": tr["params"],
        },
        "batch_stats": ae["batch_stats"],
    }


def _import_fct_transformer(sd, prefix: str, dim: int):
    p: Dict[str, Any] = {}
    ao: Dict[str, Any] = {}
    for n in ("q", "k", "v"):
        ao[f"conv_{n}"] = _conv(sd, f"{prefix}.attention_output.conv_{n}")
        ao[f"layernorm_{n}"] = _ln(sd, f"{prefix}.attention_output.layernorm_{n}")
    w_in = _np(sd[f"{prefix}.attention_output.attention.in_proj_weight"])
    b_in = _np(sd[f"{prefix}.attention_output.attention.in_proj_bias"])
    mha: Dict[str, Any] = {}
    for i, n in enumerate(("q", "k", "v")):
        mha[f"{n}_proj"] = {
            "kernel": np.ascontiguousarray(w_in[i * dim:(i + 1) * dim].T),
            "bias": b_in[i * dim:(i + 1) * dim],
        }
    mha["out_proj"] = _linear(sd, f"{prefix}.attention_output.attention.out_proj")
    ao["attention"] = mha
    p["attention_output"] = ao
    p["conv1"] = _conv(sd, f"{prefix}.conv1")
    p["layernorm"] = _ln(sd, f"{prefix}.layernorm")
    p["wide_focus"] = {
        f"conv{i}": _conv(sd, f"{prefix}.wide_focus.conv{i}") for i in (1, 2, 3, 4)
    }
    return p


def import_fct(sd, filters=(8, 16, 32, 64, 128, 64, 32, 16, 8)) -> Dict[str, Any]:
    """FCT checkpoint (FCT.py:210-254 module) -> flax FCT params."""
    params: Dict[str, Any] = {}
    for i in range(1, 10):
        t = f"block_{i}"
        bp: Dict[str, Any] = {}
        if i <= 5:
            if i in (1, 5):
                bp["conv1_a"] = _conv(sd, f"{t}.conv1_a")
            else:
                bp["conv1_b"] = _conv(sd, f"{t}.conv1_b")
                bp["conv3"] = _conv(sd, f"{t}.conv3")
            bp["conv2"] = _conv(sd, f"{t}.conv2")
        else:
            for n in ("conv1", "conv2", "conv3"):
                bp[n] = _conv(sd, f"{t}.{n}")
        bp["trans"] = _import_fct_transformer(sd, f"{t}.trans", filters[i - 1])
        params[t] = bp
    params["ds"] = {f"conv{i}": _conv(sd, f"ds.conv{i}") for i in (1, 2, 3)}
    return {"params": params}


def import_autoencoder(sd) -> Dict[str, Any]:
    """AutoEncoder.py (multi-scale conv AE) checkpoint -> flax params."""
    enc: Dict[str, Any] = {}
    for i in range(1, 6):
        t = f"encoder.block_{i}"
        bp = {}
        for n in ("conv1_a", "conv1_b", "conv2", "conv3"):
            if f"{t}.{n}.weight" in sd:
                bp[n] = _conv(sd, f"{t}.{n}")
        enc[f"block_{i}"] = bp
    dec: Dict[str, Any] = {}
    for i in range(1, 5):
        t = f"decoder.block_{i}"
        dec[f"block_{i}"] = {n: _conv(sd, f"{t}.{n}")
                             for n in ("conv1", "conv2", "conv3")}
    dec["ds"] = {f"conv{i}": _conv(sd, f"decoder.ds.conv{i}") for i in (1, 2, 3)}
    return {"params": {"encoder": enc, "decoder": dec}}


MODELS = ("unet", "fct", "autoencoder", "ae32k", "ae4k", "transformer", "hybrid")


def _kernel(params: Dict[str, Any], *path: str) -> np.ndarray:
    for p in path:
        params = params[p]
    return params["kernel"]


def _port_model(name: str, variables: Dict[str, Any]) -> torch.nn.Module:
    """The port's model of family ``name`` on the CPU, its configuration
    read from the imported shapes (the reference's files carry no config);
    attention head counts, which no weight shape fixes, are 1."""
    from tchvp_tpu_torch.config import (
        AutoEncoderConfig,
        ResNetAEConfig,
        TransformerConfig,
        UNetConfig,
        flagship_video_config,
    )

    p = variables["params"]
    if name == "unet":
        k1, head = _kernel(p, "encoder1", "conv1"), _kernel(p, "conv")
        from tchvp_tpu_torch.models.unet import UNet

        return UNet(UNetConfig(in_channels=k1.shape[2], out_channels=head.shape[3],
                               init_features=k1.shape[3]), device="cpu")
    if name == "fct":
        from tchvp_tpu_torch.models.fct import FCT

        return FCT(device="cpu", in_channels=_kernel(p, "block_1", "conv1_a").shape[2])
    if name == "autoencoder":
        from tchvp_tpu_torch.models.autoencoder import AutoEncoder

        enc = p["encoder"]
        filters = tuple(_kernel(enc, f"block_{i + 1}", "conv2").shape[3] for i in range(len(enc)))
        return AutoEncoder(AutoEncoderConfig(filters=filters,
                                             out_channels=_kernel(p, "decoder", "ds", "conv3").shape[3]),
                           in_channels=_kernel(enc, "block_1", "conv1_a").shape[2], device="cpu")
    if name in ("ae32k", "ae4k"):
        from tchvp_tpu_torch.models.resnet_ae import Autoencoder4K, Autoencoder32K

        output_type = "mask" if _kernel(p, "decoder", "head_conv").shape[3] == 1 else "image"
        if name == "ae4k":
            return Autoencoder4K(output_type, device="cpu")
        return Autoencoder32K(ResNetAEConfig(output_type=output_type), device="cpu")
    from tchvp_tpu_torch.models.transformer import TransformerEncoder
    from tchvp_tpu_torch.models.video import VideoHybridNet

    t = p["temporal"] if name == "hybrid" else p
    n = sum(1 for k in t if k.startswith("attention_"))
    d, hidden = _kernel(t, "ffn1_0").shape
    if name == "transformer":
        return TransformerEncoder(TransformerConfig(input_dim=d, hidden_dim=hidden, num_layers=n,
                                                    num_heads=1))
    size = 4 * int(round(d ** 0.5))
    return VideoHybridNet(flagship_video_config(size, num_heads=1, hidden_dim=hidden, num_layers=n),
                          device="cpu")


def import_reference(name: str, sd, temporal_sd=None) -> Tuple[torch.nn.Module, Dict[str, Any]]:
    """A reference state_dict (and, for ``"hybrid"``, the temporal
    transformer's) -> (the port's model of that family on the CPU holding
    the weights, the flax-layout variables they went through). ``name`` is
    one of :data:`MODELS`, the JAX package's ``port --model`` choices."""
    if name == "transformer":
        variables = import_transformer_encoder(sd, num_attention_layers(sd))
    elif name == "hybrid":
        if temporal_sd is None:
            raise ValueError("importing the hybrid needs the temporal transformer's state_dict too")
        variables = import_video_hybrid(sd, temporal_sd, num_layers=num_attention_layers(temporal_sd))
    elif name in MODELS:
        variables = {"unet": import_unet, "fct": import_fct, "autoencoder": import_autoencoder,
                     "ae32k": import_autoencoder32k, "ae4k": import_autoencoder4k}[name](sd)
    else:
        raise ValueError(f"unknown model {name!r} (choose from {MODELS})")
    model = _port_model(name, variables)
    if name == "transformer":  # the port's converter reads the layers under "temporal"
        state = {k[len("temporal."):]: v
                 for k, v in from_flax({"params": {"temporal": variables["params"]}}).items()}
    else:
        state = from_flax(variables)
    model.load_state_dict(state, strict=True)
    return model, variables
