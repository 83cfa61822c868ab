"""Carry weights from the JAX package's flax variables into the port.

:func:`from_flax` takes the ``{"params", "batch_stats"}`` tree of a JAX
model (``{"params"}`` for one without BatchNorm: numpy arrays, or anything
``np.asarray`` takes) and returns a ``state_dict`` for the port's
counterpart: ``VideoHybridNet``, ``FCT``, ``UNet``, ``AutoEncoder``,
``Image2Image2Mask``, ``Autoencoder32K`` (its ``mu``/``logvar`` heads
too), ``Autoencoder4K`` or one of their submodules at its flax path. The
families after the flagship keep flax's module names, so their paths map
one to one. It runs the maps of ``tchvp_tpu/utils/torch_port.py``
backwards:

* conv kernels HWIO -> OIHW (a depthwise (3, 3, 1, C) kernel -> (C, 1, 3, 3));
* Dense kernels (in, out) -> (out, in);
* LayerNorm ``scale``/``bias`` -> ``weight``/``bias``;
* BatchNorm ``.../BatchNorm_0/{scale, bias}`` and batch stats
  ``.../BatchNorm_0/{mean, var}`` -> ``weight``, ``bias``,
  ``running_mean``, ``running_var`` (and ``num_batches_tracked`` 0);
* the MoE pool ``temporal/moe_{layer}/{router, w1, b1, w2, b2}`` as it
  is: the port keeps JAX's layout;
* ConvTranspose kernels (kh, kw, in, out), applied spatially flipped by
  flax, -> ``transpose(k[::-1, ::-1], (2, 3, 0, 1))``. A module is a
  ConvTranspose by its kind in the table below (the modules flax names
  ``upconv<N>``: ``Decoder32K``'s and UNet's), not by where the port
  keeps it.

Every leaf maps to exactly one entry; ``load_state_dict(strict=True)``
checks that every entry of the port is covered.

:func:`from_flax_state` carries a whole JAX ``TrainState`` across: the
variables as above, and the optax state (moments, count, parameter EMA)
through the same leaf maps into the port's checkpoint payload.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}

CONV = "conv"  # Conv, Dense, norms: the leaf maps by its rank
CONV_TRANSPOSE = "conv_transpose"
MOE = "moe"  # the routed FFN pool: every leaf as it is

# (flax module path regex, torch module path template, kind), tried in order.
_MODULES = [
    (r"encoder/(stem_conv|stem_bn)", r"encoder.\1", CONV),
    (r"encoder/(layer\d+_block\d+)/(\w+)", r"encoder.blocks.\1.\2", CONV),
    (r"encoder/squeeze(\d+)_conv", lambda m: f"encoder.squeeze.{3 * int(m[1])}", CONV),
    (r"encoder/squeeze(\d+)_bn", lambda m: f"encoder.squeeze.{3 * int(m[1]) + 1}", CONV),
    (r"temporal/norm_(\d+)", r"temporal.layers.\1.norm", CONV),
    (r"temporal/attention_(\d+)/(\w+)", r"temporal.layers.\1.attention.\2", CONV),
    (r"temporal/(ffn[12])_(\d+)", r"temporal.layers.\2.\1", CONV),
    (r"temporal/moe_(\d+)", r"temporal.layers.\1.moe", MOE),
    (r"decoder/conv(\d+)", r"decoder.convs.\1", CONV),
    (r"decoder/bn(\d+)", r"decoder.conv_bns.\1", CONV),
    (r"decoder/upconv(\d+)", r"decoder.upconvs.\1", CONV_TRANSPOSE),
    (r"decoder/up_bn(\d+)", r"decoder.up_bns.\1", CONV),
    (r"decoder/post_conv(\d+)", r"decoder.post_convs.\1", CONV),
    (r"decoder/post_bn(\d+)", r"decoder.post_bns.\1", CONV),
    (r"decoder/(head_conv|head_bn)", r"decoder.\1", CONV),
    # UNet (alone or as Image2Image2Mask's ``unet``): its ConvTransposes.
    (r"((?:unet/)?upconv\d)", lambda m: m[1].replace("/", "."), CONV_TRANSPOSE),
    # FCT, UNet, AutoEncoder, Image2Image2Mask, Autoencoder32K's mu/logvar:
    # flax's names.
    (r"(\w+(?:/\w+)*)", lambda m: m[1].replace("/", "."), CONV),
]


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def _module_name(path: Tuple[str, ...]) -> Tuple[str, str]:
    """(the port's module path, the flax module's kind) of a flax module path."""
    flax_path = "/".join(p for p in path if p != "BatchNorm_0")
    for pattern, template, kind in _MODULES:
        m = re.fullmatch(pattern, flax_path)
        if m:
            return (template(m) if callable(template) else m.expand(template)), kind
    raise KeyError(f"no port module for flax module {'/'.join(path)}")


def _convert(kind: str, leaf: str, arr: np.ndarray) -> Tuple[str, np.ndarray]:
    if kind == MOE:
        return leaf, arr
    if leaf != "kernel":
        return _LEAF[leaf], arr
    if kind == CONV_TRANSPOSE:  # flax applies the kernel spatially flipped
        return "weight", np.transpose(arr[::-1, ::-1], (2, 3, 0, 1))
    if arr.ndim == 2:  # Dense (in, out) -> (out, in)
        return "weight", arr.T
    return "weight", np.transpose(arr, (3, 2, 0, 1))  # HWIO -> OIHW


def _flax_monolithic(params: Mapping[str, Any]) -> Mapping[str, Any]:
    """A flagship param tree in JAX's pipelined layout (``{"rest",
    "stages"}``, ``parallel/pipeline.py::create_pipelined_train_state``:
    the temporal layers stacked, (P, ...) or stage-grouped (P, k, ...))
    as the flax module tree (JAX's ``merge_pipelined_params``); any other
    tree as it is."""
    if not (isinstance(params, Mapping) and set(params) == {"rest", "stages"}
            and isinstance(params["stages"], Mapping) and "norm" in params["stages"]):
        return params
    stages = params["stages"]
    ref = np.asarray(next(v for _, v in _leaves(stages["norm"])))
    num_layers = ref.shape[0] * (ref.shape[1] if ref.ndim == 3 else 1)
    temporal: Dict[str, Any] = {}
    for path, value in _leaves(stages):
        arr = np.asarray(value)
        arr = arr.reshape((num_layers,) + arr.shape[2:]) if arr.shape[0] != num_layers else arr
        for i in range(num_layers):
            node = temporal.setdefault(f"{path[0]}_{i}", {})
            for key in path[1:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = arr[i]
    return {**params["rest"], "temporal": temporal}


def from_flax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax ``{"params", "batch_stats"}`` (or ``{"params"}``) of a JAX
    model -> ``state_dict`` of the port's counterpart (module docstring).
    A flagship's params may be in JAX's pipelined layout too
    (:func:`_flax_monolithic`); ``parallel/pipeline.py::pipelined_layout``
    gives the port's pipelined layout of the result."""
    state: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        tree = variables.get(collection, {})
        if collection == "params":
            tree = _flax_monolithic(tree)
        for path, value in _leaves(tree):
            module, kind = _module_name(path[:-1])
            leaf, arr = _convert(kind, path[-1], np.asarray(value, dtype=np.float32))
            key = f"{module}.{leaf}"
            if key in state:
                raise ValueError(f"two flax leaves map to {key}")
            state[key] = torch.from_numpy(np.array(arr, order="C"))
            if leaf == "running_mean":
                state[f"{module}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return state


def _fields(node: Any):
    """A namedtuple's fields or a mapping's items (an untyped orbax restore
    turns optax namedtuples into name-keyed dicts), else None."""
    if hasattr(node, "_fields"):
        return {f: getattr(node, f) for f in node._fields}
    if isinstance(node, Mapping):
        return dict(node)
    return None


def _find(node: Any, match) -> Any:
    """The first node (depth first) whose fields satisfy ``match``."""
    fields = _fields(node)
    if fields is not None and match(set(fields)):
        return fields
    children = fields.values() if fields is not None else (
        node if isinstance(node, (list, tuple)) else ())
    for child in children:
        found = _find(child, match)
        if found is not None:
            return found
    return None


def _param_tree(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A param-shaped optax tree (moments, the EMA) through the leaf maps
    of :func:`from_flax`; leaves that are not arrays (optax's masked
    placeholders of frozen subtrees) are skipped."""
    def arrays(t):
        return {k: arrays(v) if isinstance(v, Mapping) else v
                for k, v in t.items() if isinstance(v, Mapping) or hasattr(v, "shape")}
    return from_flax({"params": arrays(tree)})


def from_flax_state(state: Any) -> Dict[str, Any]:
    """A JAX ``TrainState`` (or a ``save_state`` payload: ``params``,
    ``batch_stats``, ``opt_state``, ``step``) -> the port's checkpoint
    payload (``train/checkpoint.py``): ``"model"``, ``"opt_state"`` with
    the moments keyed by parameter name, the update ``count``,
    ``notfinite_count`` and the ``ema``, and ``"train_step"``.

    The optax state is read by its fields, from numpy, so namedtuples and
    the name-keyed dicts of an untyped orbax restore both work: Adam's
    ``ScaleByAdamState`` (``mu``, ``nu``, ``count``) becomes AdamW's
    ``exp_avg``, ``exp_avg_sq`` and ``step``; ``EmaState`` the EMA;
    ``ApplyIfFiniteState.notfinite_count`` the skip count. A payload's
    ``step`` is its tag, a ``TrainState``'s the steps taken."""
    get = (lambda k: state.get(k)) if isinstance(state, Mapping) else (lambda k: getattr(state, k, None))
    model = from_flax({"params": get("params"), "batch_stats": get("batch_stats") or {}})
    opt = get("opt_state")
    moments: Dict[str, Dict[str, torch.Tensor]] = {}
    count = 0
    adam = _find(opt, lambda f: f == {"count", "mu", "nu"})
    if adam is not None:
        count = int(np.asarray(adam["count"]))
        mu, nu = _param_tree(adam["mu"]), _param_tree(adam["nu"])
        moments = {n: {"step": torch.tensor(float(count)), "exp_avg": mu[n], "exp_avg_sq": nu[n]}
                   for n in mu}
    ema = _find(opt, lambda f: f == {"ema"})
    finite = _find(opt, lambda f: "notfinite_count" in f)
    return {
        "model": model,
        "opt_state": {
            "moments": moments,
            "count": count,
            "notfinite_count": int(np.asarray(finite["notfinite_count"])) if finite else 0,
            "ema": _param_tree(ema["ema"]) if ema is not None else None,
        },
        "train_step": int(np.asarray(get("step") or 0)),
    }
