"""Carry weights from the JAX package's flax variables into the port.

:func:`from_flax` takes a ``VideoHybridNet``'s ``{"params",
"batch_stats"}`` tree (numpy arrays, or anything ``np.asarray`` takes)
and returns a ``state_dict`` for :class:`tchvp_tpu_torch.models.video.
VideoHybridNet`. It runs the maps of ``tchvp_tpu/utils/torch_port.py``
backwards:

* conv kernels HWIO -> OIHW;
* Dense kernels (in, out) -> (out, in);
* LayerNorm ``scale``/``bias`` -> ``weight``/``bias``;
* BatchNorm ``.../BatchNorm_0/{scale, bias}`` and batch stats
  ``.../BatchNorm_0/{mean, var}`` -> ``weight``, ``bias``,
  ``running_mean``, ``running_var`` (and ``num_batches_tracked`` 0);
* ConvTranspose kernels (kh, kw, in, out), applied spatially flipped by
  flax, -> ``transpose(k[::-1, ::-1], (2, 3, 0, 1))``.

Every leaf maps to exactly one entry; ``load_state_dict(strict=True)``
checks that every entry of the port is covered.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}

# (flax module path regex, torch module path template), tried in order.
_MODULES = [
    (r"encoder/(stem_conv|stem_bn)", r"encoder.\1"),
    (r"encoder/(layer\d+_block\d+)/(\w+)", r"encoder.blocks.\1.\2"),
    (r"encoder/squeeze(\d+)_conv", lambda m: f"encoder.squeeze.{3 * int(m[1])}"),
    (r"encoder/squeeze(\d+)_bn", lambda m: f"encoder.squeeze.{3 * int(m[1]) + 1}"),
    (r"temporal/norm_(\d+)", r"temporal.layers.\1.norm"),
    (r"temporal/attention_(\d+)/(\w+)", r"temporal.layers.\1.attention.\2"),
    (r"temporal/(ffn[12])_(\d+)", r"temporal.layers.\2.\1"),
    (r"decoder/conv(\d+)", r"decoder.convs.\1"),
    (r"decoder/bn(\d+)", r"decoder.conv_bns.\1"),
    (r"decoder/upconv(\d+)", r"decoder.upconvs.\1"),
    (r"decoder/up_bn(\d+)", r"decoder.up_bns.\1"),
    (r"decoder/post_conv(\d+)", r"decoder.post_convs.\1"),
    (r"decoder/post_bn(\d+)", r"decoder.post_bns.\1"),
    (r"decoder/(head_conv|head_bn)", r"decoder.\1"),
]


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def _module_name(path: Tuple[str, ...]) -> str:
    flax_path = "/".join(p for p in path if p != "BatchNorm_0")
    for pattern, template in _MODULES:
        m = re.fullmatch(pattern, flax_path)
        if m:
            return template(m) if callable(template) else m.expand(template)
    raise KeyError(f"no port module for flax module {'/'.join(path)}")


def _convert(module: str, leaf: str, arr: np.ndarray) -> Tuple[str, np.ndarray]:
    if leaf != "kernel":
        return _LEAF[leaf], arr
    if arr.ndim == 2:  # Dense (in, out) -> (out, in)
        return "weight", arr.T
    if ".upconvs." in module:  # flax applies the kernel spatially flipped
        return "weight", np.transpose(arr[::-1, ::-1], (2, 3, 0, 1))
    return "weight", np.transpose(arr, (3, 2, 0, 1))  # HWIO -> OIHW


def from_flax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax ``{"params", "batch_stats"}`` of the JAX ``VideoHybridNet`` ->
    ``state_dict`` of the port's ``VideoHybridNet``."""
    state: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, value in _leaves(variables.get(collection, {})):
            module = _module_name(path[:-1])
            leaf, arr = _convert(module, path[-1], np.asarray(value, dtype=np.float32))
            key = f"{module}.{leaf}"
            if key in state:
                raise ValueError(f"two flax leaves map to {key}")
            state[key] = torch.from_numpy(np.array(arr, order="C"))
            if leaf == "running_mean":
                state[f"{module}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return state
