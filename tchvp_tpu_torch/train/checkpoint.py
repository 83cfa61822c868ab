"""Checkpoint / resume / transfer of the port's training state.

Counterpart of ``tchvp_tpu/train/checkpoint.py``, with its function names,
return values and directory layout: a full state lives in
``<directory>/step_<N>`` (:func:`save_state`), newest found by
:func:`latest_step_dir`, rotated by :func:`prune_step_dirs`, its tag
scheme pinned by the ``TAG_SCHEME`` marker (:func:`ensure_tag_scheme`).

The format is the port's own: ``torch.save`` of CPU tensors into
``step_<N>/state.pt``, a payload of

* ``"model"``: the model's ``state_dict`` (parameters and BatchNorm buffers);
* ``"opt_state"``: the optimizer's moments keyed by parameter NAME (a
  frozen prefix changes the core optimizer's index order, never a name),
  its update ``count``, ``notfinite_count`` and the parameter ``ema``;
* ``"train_step"``: :attr:`TrainState.step`; ``"generators"``: the states
  of the noise and dropout generators;
* ``"step"`` (the tag) and ``"extra"``.

Writes are atomic: the payload goes into a directory whose name fails the
``step_<digits>`` filter and is renamed into place, as orbax's tmp-dir
rename does for the JAX package, so :func:`prune_step_dirs` can neither
list nor delete a save in flight. ``async_write=True`` copies device ->
host now and writes on one background thread; :func:`wait_for_async_saves`
and :func:`latest_step_dir` join it and raise the first error the writer
met.

Sharded states (:func:`is_sharded_state`: FSDP's slices,
``parallel/fsdp.py``, or expert parallelism's, ``ops/moe.py``) are saved
SHARD-WISE, as JAX's orbax saves them: ``step_<N>`` then holds a
``torch.distributed.checkpoint`` of flat keys (``model.<name>``,
``moment.<name>.<key>``, ``ema.<name>``, ``generator.<name>`` and a JSON
``meta``), every rank writing its slices, each wrapped for the save as a
``DTensor`` (``Shard(dim)`` on its axis of a CPU twin of its mesh), so no
rank ever holds a whole sharded leaf. A restore into a live sharded state
(:func:`restore_state_into`) reads each rank's slice, also onto another
number of ranks or another dimension (the elastic resume); a whole
checkpoint restores into a sharded state by cutting each leaf to its
slice; :func:`restore_state` and :func:`restore_params` read a shard-wise
checkpoint whole in one process, with no process group (``eval``,
``infer``, ``export``). The ranks' collectives of a shard-wise save or
restore run over a gloo group of their own, so that an asynchronous save's
writer thread never meets the training's collectives.
"""

from __future__ import annotations

import inspect
import json
import os
import shutil
import threading
import uuid
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn as nn

from tchvp_tpu_torch.parallel.collectives import barrier
from tchvp_tpu_torch.parallel.fsdp import Placement, placement, state_leaves
from tchvp_tpu_torch.train.state import TrainState

PAYLOAD = "state.pt"
FORMAT = "tchvp_tpu_torch/1"
# The file torch.distributed.checkpoint writes beside a shard-wise save's data.
SHARDED_METADATA = ".metadata"


class _AsyncWriter:
    """One background thread that writes queued payloads in order; every
    future is kept until a join reads it, so no error is dropped."""

    def __init__(self):
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pending: List[Future] = []
        self._lock = threading.Lock()

    def submit(self, fn, *args) -> None:
        with self._lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt-writer")
            self._pending.append(self._pool.submit(fn, *args))

    def join(self) -> None:
        with self._lock:
            pending, self._pending = self._pending, []
        errors = [f.exception() for f in pending]
        first = next((e for e in errors if e is not None), None)
        if first is not None:
            raise first


_WRITER = _AsyncWriter()


def wait_for_async_saves() -> None:
    """Block until every async :func:`save_state` has committed to disk;
    raises the first exception a queued write met. Call before process
    exit and before reading a just-written step dir (the restore and
    discovery helpers here call it themselves)."""
    _WRITER.join()


def _host(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Fresh CPU copies: training goes on mutating the live tensors."""
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}


def _opt_payload(tx) -> Dict[str, Any]:
    names = {id(p): n for n, p in tx.named.items()}
    moments = {names[id(p)]: _host({k: v for k, v in st.items() if torch.is_tensor(v)})
               for p, st in tx.core.state.items() if st}
    return {"moments": moments, "count": tx.count, "notfinite_count": tx.notfinite_count,
            "ema": _host(tx.ema) if tx.ema is not None else None}


def _payload(step: int, state, extra: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    model = state.model if isinstance(state, TrainState) else state
    payload: Dict[str, Any] = {"format": FORMAT, "step": int(step),
                               "model": _host(model.state_dict())}
    if isinstance(state, TrainState):
        payload["opt_state"] = _opt_payload(state.tx)
        payload["train_step"] = int(state.step)
        payload["generators"] = {"noise": state.noise_generator.get_state(),
                                 "dropout": state.dropout_generator.get_state()}
    if extra:
        payload["extra"] = dict(extra)
    return payload


def _write(path: str, payload: Dict[str, Any]) -> None:
    """``payload`` into ``path`` through a temporary sibling renamed into
    place (an existing ``path`` is replaced, as orbax's ``force=True``)."""
    parent, name = os.path.split(path)
    os.makedirs(parent, exist_ok=True)
    tmp = os.path.join(parent, f".tmp-{name}-{uuid.uuid4().hex[:8]}")
    os.makedirs(tmp)
    try:
        torch.save(payload, os.path.join(tmp, PAYLOAD))
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def save_state(
    directory: str,
    step: int,
    state,
    extra: Optional[Dict[str, Any]] = None,
    async_write: bool = False,
    sharded: Optional[bool] = None,
) -> str:
    """Save ``state`` (a :class:`TrainState`, or a bare model) under
    ``directory/step_{step}``; returns the path.

    ``async_write=True``: the device -> host copy happens now, the disk
    write on the background writer, so the loop overlaps IO with the next
    steps; :func:`wait_for_async_saves` joins it.

    ``sharded`` (default: :func:`is_sharded_state`): a sharded state is saved
    shard-wise (module docstring) and every rank must call this; each
    copies its slices to the host now. ``sharded=True`` on a replicated
    state saves it shard-wise too, rank 0 writing each leaf."""
    if sharded is None:
        sharded = is_sharded_state(state)
    if sharded:
        return _save_sharded(directory, step, state, extra, async_write)
    return save_payload(directory, step, _payload(step, state, extra), async_write)


def save_payload(directory: str, step: int, payload: Dict[str, Any], async_write: bool = False) -> str:
    """Write a payload (:func:`_payload`'s form) under
    ``directory/step_{step}`` as :func:`save_state` does; returns the path."""
    path = os.path.join(os.path.abspath(directory), f"step_{step}")
    if async_write:
        _WRITER.submit(_write, path, payload)
    else:
        _write(path, payload)
    return path


def is_sharded_state(state) -> bool:
    """True when a rank holds only slices of some parameter of ``state``
    (a ``TrainState`` or a model): FSDP's or the experts'."""
    model = state.model if isinstance(state, TrainState) else state
    return any(placement(p) is not None for p in model.parameters())


def is_sharded_checkpoint(path: str) -> bool:
    """Whether ``path`` holds a shard-wise checkpoint."""
    return os.path.exists(os.path.join(path, SHARDED_METADATA))


def restore_state(path: str) -> Dict[str, Any]:
    """The payload saved by :func:`save_state` (or :func:`save_params`),
    CPU tensors; a shard-wise checkpoint read whole, in this process
    alone."""
    wait_for_async_saves()  # a just-queued async save must be readable
    if is_sharded_checkpoint(path):
        return _payload_of(_read_sharded_whole(path))
    return torch.load(os.path.join(path, PAYLOAD), map_location="cpu", weights_only=True)


def _check_tensors(live: Dict[str, torch.Tensor], disk: Dict[str, torch.Tensor], what: str) -> None:
    """Refuse a missing or extra key and a shape or dtype mismatch."""
    missing, extra = sorted(set(live) - set(disk)), sorted(set(disk) - set(live))
    if extra:  # a silent drop would mask a partial or mismatched restore
        raise ValueError(f"checkpoint {what} has keys absent from the live state: {extra}")
    if missing:
        raise ValueError(f"checkpoint {what} lacks live keys: {missing}")
    for k, v in live.items():
        d = disk[k]
        if tuple(v.shape) != tuple(d.shape) or v.dtype != d.dtype:
            raise ValueError(f"checkpoint {what} leaf {k}: shape {tuple(d.shape)} {d.dtype} "
                             f"!= live {tuple(v.shape)} {v.dtype}")


@torch.no_grad()
def _copy_into(live: Dict[str, torch.Tensor], disk: Dict[str, torch.Tensor]) -> None:
    for k, v in live.items():
        v.copy_(disk[k])


def _moment_template(core: torch.optim.Optimizer, dtype: torch.dtype) -> Dict[str, tuple]:
    """``{key: (is a per-element moment, dtype)}`` of the state ``core``'s
    class keeps for a parameter of ``dtype``: one step of a probe of the
    same class and settings on a two-element parameter."""
    probe = nn.Parameter(torch.zeros(2, dtype=dtype))
    accepted = inspect.signature(type(core).__init__).parameters
    opt = type(core)([probe], **{k: v for k, v in core.defaults.items() if k in accepted})
    probe.grad = torch.zeros_like(probe)
    opt.step()
    return {k: (v.dim() > 0, v.dtype) for k, v in opt.state[probe].items()}


def _check_optimizer(tx, opt: Dict[str, Any]) -> None:
    """Refuse moments that the live optimizer could not hold as its own:
    of an unknown or frozen parameter, missing for a trainable one once
    the checkpoint's optimizer has stepped, or with other keys, shapes or
    dtypes than its class keeps; and an EMA that is absent on one side
    only or does not match the live one."""
    moments = opt["moments"]
    unknown = sorted(set(moments) - set(tx.named))
    if unknown:
        raise ValueError(f"checkpoint moments of parameters absent from the live model: {unknown}")
    trainable_ids = {id(p) for p in tx.trainable}
    trainable = {n for n, p in tx.named.items() if id(p) in trainable_ids}
    frozen = sorted(set(moments) - trainable)
    if frozen:
        raise ValueError(f"checkpoint moments of parameters the live optimizer freezes: {frozen}")
    missing = sorted(trainable - set(moments))
    if missing and (moments or opt["count"]):
        raise ValueError(f"checkpoint has no moments for trainable parameters: {missing}")
    templates: Dict[torch.dtype, Dict[str, tuple]] = {}
    for n, st in moments.items():
        p = tx.named[n]
        want = templates.setdefault(p.dtype, _moment_template(tx.core, p.dtype))
        if set(st) != set(want):
            raise ValueError(f"checkpoint moments of {n} are {sorted(st)}, the live optimizer's "
                             f"{sorted(want)}")
        for k, v in st.items():
            per_element, dtype = want[k]
            shape = tuple(p.shape) if per_element else ()
            if tuple(v.shape) != shape or v.dtype != dtype:
                raise ValueError(f"checkpoint moment {k} of {n}: shape {tuple(v.shape)} {v.dtype} "
                                 f"!= live {shape} {dtype}")
    if (tx.ema is None) != (opt["ema"] is None):
        raise ValueError("checkpoint and live optimizer disagree on keeping a parameter EMA "
                         f"(checkpoint {'has' if opt['ema'] is not None else 'has no'} one)")
    if tx.ema is not None:
        _check_tensors(tx.ema, opt["ema"], "ema")


def _check_generators(state: TrainState, gens: Dict[str, torch.Tensor]) -> None:
    for name, live in (("noise", state.noise_generator), ("dropout", state.dropout_generator)):
        want, got = live.get_state(), gens[name]
        if got.dtype != want.dtype or got.shape != want.shape:
            raise ValueError(f"checkpoint {name} generator state {tuple(got.shape)} {got.dtype} "
                             f"!= live {tuple(want.shape)} {want.dtype}")


def _restore_optimizer(tx, opt: Dict[str, Any]) -> None:
    index = {id(p): i for i, p in enumerate(tx.trainable)}
    live = tx.core.state_dict()
    # Copies: torch's load_state_dict keeps the given tensors, which the
    # next step would then update inside the caller's payload.
    tx.core.load_state_dict({"state": {index[id(tx.named[n])]: {k: v.clone() if torch.is_tensor(v) else v
                                                                for k, v in st.items()}
                                       for n, st in opt["moments"].items()},
                             "param_groups": live["param_groups"]})
    tx.count = int(opt["count"])
    tx.notfinite_count = int(opt["notfinite_count"])
    if tx.ema is not None:
        _copy_into(tx.ema, opt["ema"])


def restore_state_into(state: TrainState, path: str, sharded: Optional[bool] = None):
    """Restore the model, the optimizer (moments, count, EMA), the step
    and the generators from ``path`` into the live ``state``, IN PLACE:
    parameters and buffers are ``copy_``'d, never replaced, since the
    optimizer holds references to them. Every part is checked before
    anything is written (:func:`load_payload`).

    Returns ``(state, raw)``, ``raw`` the payload (for ``step`` and
    ``extra``).

    ``sharded`` (default: :func:`is_sharded_state` of the live state): every
    rank restores its slices (:func:`_restore_state_sharded`), from a
    shard-wise checkpoint or a whole one."""
    if sharded is None:
        sharded = is_sharded_state(state)
    if sharded:
        return _restore_state_sharded(state, path)
    raw = restore_state(path)
    return load_payload(state, raw), raw


def load_payload(state: TrainState, raw: Dict[str, Any]) -> TrainState:
    """Copy a payload (:func:`restore_state`'s, or one that
    ``convert.from_flax_state`` made from a JAX state) into ``state`` in
    place, as :func:`restore_state_into` does. First every part is
    checked: the model's keys, shapes and dtypes, the moments against the
    live optimizer (:func:`_check_optimizer`), the EMA and the generator
    states; a mismatch raises ``ValueError`` with the live state untouched."""
    _check_tensors(state.model.state_dict(), raw["model"], "model")
    if "opt_state" in raw:
        _check_optimizer(state.tx, raw["opt_state"])
    gens = raw.get("generators")
    if gens is not None:
        _check_generators(state, gens)
    _copy_into(state.model.state_dict(), raw["model"])
    if "opt_state" in raw:
        _restore_optimizer(state.tx, raw["opt_state"])
    if "train_step" in raw:
        state.step = int(raw["train_step"])
    if gens is not None:
        state.noise_generator.set_state(gens["noise"])
        state.dropout_generator.set_state(gens["dropout"])
    return state


def save_params(directory: str, name: str, model: nn.Module) -> str:
    """Weights-only save (the Model.py:182 best-checkpoint pattern)."""
    path = os.path.join(os.path.abspath(directory), name)
    _write(path, {"format": FORMAT, "model": _host(model.state_dict())})
    return path


def restore_params(path: str) -> Dict[str, torch.Tensor]:
    """The model ``state_dict`` of a :func:`save_params` or
    :func:`save_state` checkpoint (a shard-wise one read whole)."""
    wait_for_async_saves()
    if is_sharded_checkpoint(path):
        flat = _read_sharded_whole(path, prefixes=("model.",))
        return {k[len("model."):]: v for k, v in flat.items() if k.startswith("model.")}
    return restore_state(path)["model"]


def restore_subtree(path: str, keys: Sequence[str]) -> Dict[str, Dict[str, torch.Tensor]]:
    """Partial restore: the ``state_dict`` of each named top-level module
    (e.g. ``("encoder",)``), loadable into that module: the AE_32K
    L233-236 encoder-transfer load."""
    params = restore_params(path)
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for k in keys:
        sub = {n[len(k) + 1:]: v for n, v in params.items() if n.startswith(k + ".")}
        if not sub:
            raise KeyError(f"checkpoint {path} has no module {k!r}")
        out[k] = sub
    return out


# ------------------------------------------------------------ shard-wise

# (the default group it was made under, the gloo group of the checkpoints)
_CKPT_GROUP: tuple = (None, None)
_CPU_MESHES: Dict[tuple, Any] = {}


def _ckpt_group() -> Optional[dist.ProcessGroup]:
    """The gloo group of every rank that shard-wise saves and restores run
    their collectives over (made by every rank at the first one under a
    default group, anew under a new one); None in a process without a
    process group."""
    global _CKPT_GROUP
    if not (dist.is_available() and dist.is_initialized()):
        return None
    if _CKPT_GROUP[0] is not dist.group.WORLD:
        _CKPT_GROUP = (dist.group.WORLD, dist.new_group(backend="gloo"))
    return _CKPT_GROUP[1]


def _cpu_mesh(mesh):
    """``mesh`` as a mesh of CPU tensors, for the DTensors of a save or
    restore (host copies): the mesh itself under gloo, else a twin of its
    layout with no process groups of its own."""
    if mesh.device_type == "cpu":
        return mesh
    key = (tuple(mesh.mesh_dim_names), tuple(mesh.mesh.shape), tuple(mesh.mesh.flatten().tolist()))
    if key not in _CPU_MESHES:
        from torch.distributed.device_mesh import DeviceMesh

        _CPU_MESHES[key] = DeviceMesh("cpu", mesh.mesh, mesh_dim_names=mesh.mesh_dim_names,
                                      _init_backend=False)
    return _CPU_MESHES[key]


def _dtensor(local: torch.Tensor, where: Placement):
    """This rank's slice ``local`` (on the host) as the DTensor of the whole
    leaf: ``Shard(dim)`` on its axis, replicated on the mesh's others."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = _cpu_mesh(where.mesh)
    places = [Shard(where.dim) if name == where.axis else Replicate() for name in mesh.mesh_dim_names]
    return DTensor.from_local(local, mesh, places, run_check=False)


def _meta(step: int, state, extra: Optional[Dict[str, Any]]) -> str:
    meta: Dict[str, Any] = {"format": FORMAT, "step": int(step), "extra": dict(extra or {})}
    if isinstance(state, TrainState):
        meta.update(train_step=int(state.step), count=state.tx.count,
                    notfinite_count=state.tx.notfinite_count, ema=state.tx.ema is not None)
    return json.dumps(meta)


def _save_sharded(directory: str, step: int, state, extra: Optional[Dict[str, Any]],
                  async_write: bool) -> str:
    """Every rank's slices (and, from one rank, each replicated leaf) under
    ``directory/step_{step}`` through ``torch.distributed.checkpoint``. The
    host copies are made now; the write (with its collectives over the
    checkpoint group) now or on the background writer."""
    entries: Dict[str, Any] = {}
    for key, (t, where) in state_leaves(state).items():
        host = t.detach().to("cpu", copy=True)
        entries[key] = _dtensor(host, where) if where is not None else host
    entries["meta"] = _meta(step, state, extra)
    path = os.path.join(os.path.abspath(directory), f"step_{step}")
    group = _ckpt_group()
    if async_write:
        _WRITER.submit(_write_sharded, path, entries, group)
    else:
        _write_sharded(path, entries, group)
    return path


def _write_sharded(path: str, entries: Dict[str, Any], group: Optional[dist.ProcessGroup]) -> None:
    """``entries`` into ``path`` through a temporary sibling of a name all
    ranks agree on, renamed into place by rank 0 once every rank's part and
    the metadata are written."""
    import torch.distributed.checkpoint as dcp

    parent, name = os.path.split(path)
    tmp = os.path.join(parent, f".tmp-{name}-sharded")
    first = group is None or dist.get_rank(group) == 0
    if first:
        os.makedirs(parent, exist_ok=True)
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
    barrier(group)
    dcp.save(entries, storage_writer=dcp.FileSystemWriter(tmp), process_group=group)
    barrier(group)
    if first:
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
    barrier(group)


def _read_metadata(path: str):
    import torch.distributed.checkpoint as dcp

    return dcp.FileSystemReader(path).read_metadata().state_dict_metadata


def _payload_of(flat: Dict[str, Any]) -> Dict[str, Any]:
    """The :func:`save_state` payload of a shard-wise checkpoint's flat
    entries (plain tensors)."""
    meta = json.loads(flat["meta"])
    model = {k[len("model."):]: v for k, v in flat.items() if k.startswith("model.")}
    raw: Dict[str, Any] = {"format": meta["format"], "step": meta["step"], "model": model}
    if meta.get("extra"):
        raw["extra"] = meta["extra"]
    if "train_step" in meta:
        moments: Dict[str, Dict[str, torch.Tensor]] = {}
        for k, v in flat.items():
            if k.startswith("moment."):
                name, key = k[len("moment."):].rsplit(".", 1)
                moments.setdefault(name, {})[key] = v
        ema = {k[len("ema."):]: v for k, v in flat.items() if k.startswith("ema.")}
        raw["opt_state"] = {"moments": moments, "count": meta["count"],
                            "notfinite_count": meta["notfinite_count"], "ema": ema if meta["ema"] else None}
        raw["train_step"] = meta["train_step"]
        raw["generators"] = {"noise": flat["generator.noise"], "dropout": flat["generator.dropout"]}
    return raw


def _read_sharded_whole(path: str, prefixes: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """A shard-wise checkpoint's flat entries read whole into host tensors
    in this process (no process group needed), or with ``prefixes`` only
    those whose keys start with one of them (and the meta)."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata

    flat: Dict[str, Any] = {"meta": ""}
    for key, md in _read_metadata(path).items():
        if isinstance(md, TensorStorageMetadata) and (prefixes is None or key.startswith(tuple(prefixes))):
            flat[key] = torch.empty(md.size, dtype=md.properties.dtype)
    dcp.load(flat, storage_reader=dcp.FileSystemReader(path), no_dist=True)
    return flat


def _live_slices(state, raw: Dict[str, Any]) -> Dict[str, Any]:
    """A whole payload cut to the slices the live sharded ``state`` holds:
    each sharded leaf, its per-element moments and its EMA."""
    params = dict(state.model.named_parameters())

    def cut(name: str, v: torch.Tensor) -> torch.Tensor:
        """``v`` (parameter ``name``'s whole value, moment or EMA) cut to
        this rank's slice where the live parameter is one."""
        p = params.get(name)
        where = placement(p) if p is not None else None
        if where is None or v.dim() == 0 or tuple(v.shape) == tuple(p.shape):
            return v
        return where.block(v).clone()

    raw["model"] = {k: cut(k, v) for k, v in raw["model"].items()}
    opt = raw.get("opt_state")
    if opt is not None:
        opt["moments"] = {n: {k: cut(n, v) for k, v in st.items()} for n, st in opt["moments"].items()}
        if opt.get("ema") is not None:
            opt["ema"] = {n: cut(n, v) for n, v in opt["ema"].items()}
    return raw


def _restore_state_sharded(state: TrainState, path: str):
    """Every rank's slices of a checkpoint into the live sharded ``state``,
    in place, checked as :func:`load_payload` checks a payload. From a
    shard-wise checkpoint each rank reads only its slices, whatever the
    ranks or the dimension that wrote them (``torch.distributed.checkpoint``
    reads the overlap of the written chunks); from a whole one it reads the
    payload and keeps its slices. Returns ``(state, raw)``."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata

    wait_for_async_saves()
    if not is_sharded_checkpoint(path):
        raw = _live_slices(state, restore_state(path))
        return load_payload(state, raw), raw
    disk = _read_metadata(path)
    leaves = state_leaves(state)
    params = dict(state.model.named_parameters())
    flat: Dict[str, Any] = {"meta": ""}
    targets: Dict[str, torch.Tensor] = {}
    for key, md in disk.items():
        if not isinstance(md, TensorStorageMetadata):
            continue
        live = leaves.get(key)
        if live is None and key.startswith("moment."):
            # Moments the live optimizer has not made yet take the shape of
            # their parameter's slice (or a scalar's).
            p = params.get(key[len("moment."):].rsplit(".", 1)[0])
            if p is not None:
                shape = tuple(p.shape) if len(md.size) else ()
                live = (torch.empty(shape, dtype=md.properties.dtype), placement(p) if len(md.size) else None)
        if live is None:
            targets[key] = torch.empty(md.size, dtype=md.properties.dtype)
            flat[key] = targets[key]
            continue
        t, where = live
        targets[key] = torch.empty(t.shape, dtype=md.properties.dtype)
        flat[key] = _dtensor(targets[key], where) if where is not None else targets[key]
    dcp.load(flat, storage_reader=dcp.FileSystemReader(path), process_group=_ckpt_group())
    targets["meta"] = flat["meta"]
    raw = _payload_of(targets)
    return load_payload(state, raw), raw


def _step_dirs(directory: str) -> List[tuple]:
    return sorted(
        (int(d.split("_", 1)[1]), d)
        for d in os.listdir(directory)
        if d.startswith("step_") and d.split("_", 1)[1].isdigit()
    )


def prune_step_dirs(directory: str, keep_last: int) -> int:
    """Delete all but the newest ``keep_last`` ``step_*`` checkpoints;
    returns the number deleted (``keep_last <= 0`` keeps everything).

    Does NOT join in-flight async saves (that would serialize the loop
    behind every save): an in-flight save lives under a temporary name
    that fails the ``step_<digits>`` filter, so it can be neither listed
    nor doomed, and once committed it is newer than anything pruned."""
    if keep_last <= 0:
        return 0
    directory = os.path.abspath(directory)
    if not os.path.isdir(directory):
        return 0
    steps = _step_dirs(directory)
    doomed = steps[:-keep_last] if keep_last < len(steps) else []
    for _, d in doomed:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)
    return len(doomed)


def ensure_tag_scheme(directory: str, scheme: str) -> None:
    """Refuse mixing checkpoint tag schemes ("epochs" vs global-batch
    "steps", the ``save_every_steps`` mode) in one directory: tags compare
    numerically, so a resumed run that switched schemes would write tags
    below the existing maximum. Records the scheme in a ``TAG_SCHEME``
    marker on first use."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    marker = os.path.join(directory, "TAG_SCHEME")
    if os.path.exists(marker):
        with open(marker) as f:
            prev = f.read().strip()
        if prev != scheme:
            raise ValueError(
                f"checkpoint dir {directory} was written with tag scheme "
                f"'{prev}' but this run uses '{scheme}' (save_every_steps "
                f"{'on' if scheme == 'steps' else 'off'}); resume with the "
                f"same setting or use a fresh checkpoint dir"
            )
    else:
        with open(marker, "w") as f:
            f.write(scheme)


def latest_step_dir(directory: str) -> Optional[str]:
    """Most recent ``step_*`` checkpoint under ``directory``, for resume."""
    wait_for_async_saves()  # in-flight async dirs must be visible and complete
    directory = os.path.abspath(directory)
    if not os.path.isdir(directory):
        return None
    steps = _step_dirs(directory)
    if not steps:
        return None
    return os.path.join(directory, steps[-1][1])
