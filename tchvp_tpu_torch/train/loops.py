"""Training and evaluation flows (survey layer L5).

Counterpart of ``tchvp_tpu/train/loops.py``'s :class:`VideoFlow` (with
``_FlowBase`` and ``_mean_of`` behind it): clip-denoising training of the
flagship with periodic step-tagged checkpoints, resume (mid-epoch too),
TensorBoard-compatible logging and the loss-health monitor; and its
:class:`SegmentationFlow`: image -> mask training of FCT with per-epoch
sneak peeks, the best-train-loss checkpoint carrying the loss history,
restore that continues the epoch numbering, and inference with Sobel
edges; its :class:`DenoisingFlow`: image denoising with the best-val-PSNR
weights file, periodic checkpoints and the blackout-inpainting test with
its side-by-side sample; and its :class:`TransferFlow`: a pretrained
``Autoencoder32K`` encoder, frozen, under a fresh mask decoder trained
with dice.

The flow runs on the device its model lives on. Datasets yield uint8
numpy batches (synthetic, CSV manifests, clippacks); :meth:`_shard` places
each one on that device, through :class:`DevicePrefetch` when
``TrainConfig.device_prefetch`` > 0. Under a ``seq`` mesh every rank is
given the global clip, and the step takes the rank's frames after drawing
the input noise at the global shape (``train/steps.py``), so the flow
itself only places. Under a ``data`` mesh every flow reads each rank's
block of the global batch (:class:`~tchvp_tpu_torch.parallel.input.GlobalBatchLoader`
over the dataset, unless it already is one, such as a sharded ClipPack);
the steps reduce over the axis. Under a ``spatial`` mesh (``sp_axis``, the
model's own) every rank of the axis is given the same batch and the model
takes its block of the rows (``parallel/spatial.py``). ``VideoFlow(pipe_axis=)``
trains the pipelined layout (``parallel/pipeline.py``): each rank of the
axis holds one stage of the temporal layers and its moments, saves
shard-wise, and :meth:`VideoFlow.resume` converts a checkpoint of the
other layout (JAX's layout-elastic resume).

Host syncs. JAX's loop reads every metric on the host after every step.
Here the per-epoch sums stay on the device, in float64, and are read once
at the epoch's end: the same values as a per-step read summed in Python
floats (float64, same order). Only the health monitor reads the loss each
step, when one is given.

Under a mesh of several ranks the parameters stay bit-equal across ranks
(``train/steps.py``), so rank 0 alone writes checkpoints, the TAG_SCHEME
marker and the event files; every rank computes the same tags. Where each
rank holds only slices of some parameters (an ``expert`` mesh,
``ops/moe.py``; ``VideoFlow(fsdp_axis=)``, ``parallel/fsdp.py``) every rank
takes part in a save, which is shard-wise (``train/checkpoint.py``), and a
resume reads each rank's slices; the whole model's readers
(``checkpoint.restore_state``) read such a checkpoint whole.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

from tchvp_tpu_torch.config import AugmentConfig, ResNetAEConfig, TrainConfig
from tchvp_tpu_torch.data import pipeline
from tchvp_tpu_torch.data.device_prefetch import DevicePrefetch
from tchvp_tpu_torch.ops.sobel import sobel_edges
from tchvp_tpu_torch.parallel import DATA_AXIS, activate_mesh, axis_size
from tchvp_tpu_torch.parallel import fsdp
from tchvp_tpu_torch.parallel.input import GlobalBatchLoader
from tchvp_tpu_torch.train import checkpoint as ckpt
from tchvp_tpu_torch.train import steps as steps_lib
from tchvp_tpu_torch.train.health import HealthMonitor, TrainingDiverged, recover_latest
from tchvp_tpu_torch.train.logging import SummaryWriter
from tchvp_tpu_torch.models.resnet_ae import Autoencoder32K
from tchvp_tpu_torch.train.state import (
    TrainState,
    create_train_state,
    human_param_count,
    make_optimizer,
    param_count,
)
from tchvp_tpu_torch.utils.imaging import save_sample_triplet, save_side_by_side


def _mean_of(metric_sums: dict, n: int) -> dict:
    return {k: v / max(n, 1) for k, v in metric_sums.items()}


def _rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


class _FlowBase:
    def __init__(self, cfg: TrainConfig, mesh, device: torch.device):
        self.cfg = cfg
        self.mesh = mesh
        self.device = torch.device(device)
        self.writer: Optional[SummaryWriter] = None

    def _writer(self) -> SummaryWriter:
        if self.writer is None:
            self.writer = SummaryWriter(os.path.join(self.cfg.log_dir, self.cfg.model_name))
        return self.writer

    def _shard(self, batch):
        """The batch (or an (images, masks) pair) on the flow's device (a
        no-op for a placed batch)."""
        if isinstance(batch, (tuple, list)):
            return tuple(torch.as_tensor(b).to(self.device) for b in batch)
        return torch.as_tensor(batch).to(self.device)

    def _local(self, data, microbatches: int = 1):
        """``data`` as this rank reads it: under a mesh carrying ``data``,
        its block of every global batch, with ``microbatches`` its share of
        each (a :class:`GlobalBatchLoader` passes as it is, and must have
        been made for as many)."""
        mesh = self.mesh
        if (data is None or mesh is None
                or DATA_AXIS not in (mesh.mesh_dim_names or ()) or axis_size(mesh, DATA_AXIS) <= 1):
            return data
        if isinstance(data, GlobalBatchLoader):
            if data.microbatches != microbatches:
                raise ValueError(f"the loader gives each rank its share of {data.microbatches} microbatches, "
                                 f"the step takes {microbatches}")
            return data
        return GlobalBatchLoader(data, mesh, microbatches=microbatches)

    def _under_mesh(self, fn: Callable) -> Callable:
        """``fn`` run inside ``activate_mesh(self.mesh)``: the parallel
        paths read the ambient mesh."""
        if self.mesh is None:
            return fn

        def wrapped(*a, **k):
            with activate_mesh(self.mesh):
                return fn(*a, **k)

        return wrapped

    def _prefetched(self, data):
        """``data`` behind device-side lookahead when the config asks for
        it (``TrainConfig.device_prefetch``): the host-to-device copy of the
        next batches rides under the running step. Sized datasets only
        (the position-accounting contract needs ``len``)."""
        n = self.cfg.device_prefetch
        if n and data is not None and hasattr(data, "__len__"):
            return DevicePrefetch(data, n, device=self.device)
        return data

    def _log(self, tag: str, value: float, step: int) -> None:
        if _rank() == 0:
            self._writer().add_scalar(tag, value, step)

    def _optimizer(self, lr: Optional[float], frozen_prefixes=()):
        cfg = self.cfg
        return make_optimizer(lr or cfg.lr, cfg.weight_decay, grad_clip_norm=1.0,
                              frozen_prefixes=frozen_prefixes,
                              schedule=cfg.schedule, warmup_steps=cfg.warmup_steps,
                              total_steps=cfg.total_steps, min_lr_ratio=cfg.min_lr_ratio,
                              ema_decay=cfg.ema_decay, optimizer=cfg.optimizer)


def _host_sums(sums: Optional[Dict[str, torch.Tensor]], keys) -> Dict[str, float]:
    """An epoch's device sums read on the host (zeros for an empty epoch)."""
    return {k: float(v) for k, v in sums.items()} if sums else {k: 0.0 for k in keys}


def _epoch_sums(sums: Optional[Dict[str, torch.Tensor]], m: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
    """``m`` added into float64 sums on its device (made at the first
    step); read on the host once per epoch."""
    if sums is None:
        sums = {k: torch.zeros((), dtype=torch.float64, device=v.device) for k, v in m.items()}
    for k, s in sums.items():
        s += m[k].detach().double()
    return sums


def _convert_moments(moments: Dict[str, Dict[str, torch.Tensor]], conv: Callable,
                     names: Iterable[str]) -> Dict[str, Dict[str, torch.Tensor]]:
    """Optimizer moments keyed by parameter name, converted by ``conv`` (a
    layout change of a dict of the model's names): each per-element moment
    as its parameters are; a scalar one (Adam's step count, the same for
    every parameter) copied to each of the live parameters ``names``."""
    keys = sorted({k for st in moments.values() for k in st})
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for key in keys:
        per = {n: st[key] for n, st in moments.items() if key in st}
        value = next(iter(per.values()))
        if value.dim() == 0:
            for n in names:
                out.setdefault(n, {})[key] = value.clone()
        else:
            for n, v in conv(per).items():
                out.setdefault(n, {})[key] = v
    return out


def _check_sp_axis(model: torch.nn.Module, sp_axis: Optional[str]) -> None:
    """A flow's ``sp_axis`` must be the model's own (the flagship's encoder
    config's, FCT's config's): the model slices the rows it is given, and
    the flow places every rank of the axis the same batch."""
    config = getattr(model, "config", None)
    want = getattr(getattr(config, "encoder", config), "sp_axis", None)
    if sp_axis is not None and sp_axis != want:
        raise ValueError(f"sp_axis={sp_axis!r} must match the model config's sp_axis={want!r}")


class VideoFlow(_FlowBase):
    """Clip-denoising training for the video pipeline (recovered
    AE_256_32K L226-330: gaussian input noise, MixedLoss(0.3, 0.7),
    checkpoint every N epochs, resume-from-checkpoint). ``model`` is an
    initialised :class:`VideoHybridNet`; the flow runs on its device."""

    def __init__(
        self,
        model: torch.nn.Module,
        cfg: TrainConfig = TrainConfig(model_name="video", loss="mixed"),
        image_size: int = 256,
        mesh=None,
        loss_alpha: float = 0.3,
        loss_beta: float = 0.7,
        remat: bool = False,
        remat_policy: str = "none",
        fsdp_axis: Optional[str] = None,
        accum_steps: int = 1,
        qat: bool = False,
        qat_dense: bool = False,
        seq_axis: Optional[str] = None,
        sp_axis: Optional[str] = None,
        pipe_axis: Optional[str] = None,
        pipe_microbatches: Optional[int] = None,
        pipe_batch_axis: str = "data",
        aug: AugmentConfig = AugmentConfig(),
        ep_axis: Optional[str] = None,
    ):
        super().__init__(cfg, mesh, next(model.parameters()).device)
        if pipe_axis is not None and (mesh is None or pipe_axis not in (mesh.mesh_dim_names or ())):
            raise ValueError(f"pipe_axis={pipe_axis!r} needs a mesh carrying that axis")
        if fsdp_axis is not None and (mesh is None or fsdp_axis not in (mesh.mesh_dim_names or ())):
            raise ValueError(f"fsdp_axis={fsdp_axis!r} needs a mesh carrying that axis")
        _check_sp_axis(model, sp_axis)
        for name, axis in (("seq_axis", seq_axis), ("ep_axis", ep_axis)):
            want = getattr(getattr(getattr(model, "config", None), "temporal", None), name, None)
            if axis is not None and axis != want:
                raise ValueError(f"{name}={axis!r} must match the model config's "
                                 f"temporal.{name}={want!r}")
        self.ep_axis = ep_axis
        self.fsdp_axis = fsdp_axis
        self.expert_names = []
        if ep_axis is not None and mesh is not None:
            from tchvp_tpu_torch.ops.moe import shard_experts

            with activate_mesh(mesh):
                self.expert_names = shard_experts(model, ep_axis)
        self.model = model
        self.image_size = image_size
        self.state: Optional[TrainState] = None
        self.seq_axis = seq_axis
        self.accum_steps = accum_steps
        self.pipe_axis = pipe_axis
        if pipe_axis is not None:
            batch_axis = (pipe_batch_axis if pipe_batch_axis in mesh.mesh_dim_names
                          and axis_size(mesh, pipe_batch_axis) > 1 else None)
            self._train_step = self._under_mesh(steps_lib.make_pipelined_video_train_step(
                image_size, pipe_axis, batch_axis, pipe_microbatches, cfg.loss, loss_alpha, loss_beta,
                aug=aug, remat=remat or remat_policy == "full", data_range=cfg.mixed_data_range,
                fsdp_axis=fsdp_axis, fsdp_mesh=mesh if fsdp_axis else None, accum_steps=accum_steps,
                moe_aux_weight=cfg.moe_aux_weight))
            self._eval_step = self._under_mesh(steps_lib.make_pipelined_video_eval_step(
                image_size, pipe_axis, batch_axis, pipe_microbatches))
            return
        self._train_step = self._under_mesh(steps_lib.make_video_train_step(
            image_size, cfg.loss, loss_alpha, loss_beta, aug=aug, remat=remat,
            remat_policy=remat_policy, data_range=cfg.mixed_data_range,
            moe_aux_weight=cfg.moe_aux_weight, fsdp_axis=fsdp_axis,
            fsdp_mesh=mesh if fsdp_axis else None, accum_steps=accum_steps,
            qat=qat, qat_dense=qat_dense,
        ))
        self._eval_step = self._under_mesh(steps_lib.make_video_eval_step(
            image_size, qat=qat, qat_dense=qat_dense))

    def init_state(self, clip_len: int, lr: Optional[float] = None) -> TrainState:
        """A step-0 state over the model as it stands, its generators
        seeded from ``cfg.seed``; with ``fsdp_axis``, sharded over it
        (``fsdp.shard_train_state``; a restore keeps the placement).
        ``clip_len`` is kept for the JAX signature (flax needs an example
        input to initialise)."""
        del clip_len
        if self.pipe_axis is not None:
            from tchvp_tpu_torch.parallel.pipeline import create_pipelined_train_state

            self.state = create_pipelined_train_state(self.model, self._optimizer(lr), rng=self.cfg.seed,
                                                      mesh=self.mesh, axis=self.pipe_axis,
                                                      fsdp_axis=self.fsdp_axis)
            return self.state
        self.state = create_train_state(self.model, self._optimizer(lr), rng=self.cfg.seed)
        if self.fsdp_axis is not None:
            fsdp.shard_train_state(self.state, self.mesh, self.fsdp_axis)
            print(f"FSDP over {self.fsdp_axis!r} ({axis_size(self.mesh, self.fsdp_axis)} ranks): state bytes "
                  f"on this rank {fsdp.sharded_size_bytes(self.state)} of {fsdp.global_size_bytes(self.state)}")
        return self.state

    def evaluate(self, data: Iterable) -> float:
        """Mean reconstruction PSNR over a clip dataset."""
        total, n = None, 0
        for batch in self._local(data):
            psnr = self._eval_step(self.state, self._shard(batch))["psnr"].double()
            total = psnr if total is None else total + psnr
            n += 1
        return (float(total) if total is not None else 0.0) / max(n, 1)

    def resume(self, clip_len: int, data: Optional[Any] = None) -> int:
        """Restore the latest step-tagged checkpoint (model, BatchNorm
        stats, optimizer moments, EMA, generators) in place; returns the
        start epoch.

        ``data``: the training dataset. When the checkpoint was taken
        mid-epoch (``train(save_every_steps=N)``) and ``data`` supports
        ``seek`` (:class:`ClipPackDataset`), the iterator is positioned at
        the exact next batch. A mid-epoch checkpoint with non-seekable data
        falls back to replaying the whole epoch (with a warning). A
        checkpoint of another layout (monolithic or pipelined, or pipelined
        over another stage count) is converted into the live one
        (:meth:`_resume_convert_layout`)."""
        path = ckpt.latest_step_dir(self.cfg.checkpoint_dir)
        if path is None:
            return 0
        if self.state is None:
            self.init_state(clip_len)
        try:
            self.state, raw = ckpt.restore_state_into(self.state, path)
        except Exception as err:  # noqa: BLE001 (a layout mismatch fails in many ways; others re-raise)
            raw = self._resume_convert_layout(path, err)
        extra = raw.get("extra") or {}
        epoch = int(extra.get("train_epoch", raw.get("step", 0)))
        pos = extra.get("data_position")
        seekable = data is not None and hasattr(data, "seek")
        if pos is not None and seekable:
            # Seek even at batch 0: an epoch-boundary checkpoint must
            # continue the recorded data stream (epoch pos["epoch"]),
            # not restart a fresh dataset at its epoch-0 permutation.
            data.seek(int(pos["epoch"]), int(pos["batch"]))
        if pos is not None and int(pos["batch"]) > 0:
            if not seekable:
                print("[resume] mid-epoch checkpoint but data is not "
                      "seekable; replaying epoch from its start")
            return epoch - 1  # re-enter the partial epoch
        return epoch

    def _resume_convert_layout(self, path: str, err: Exception) -> dict:
        """JAX's layout-elastic resume: when the checkpoint's layout
        differs from the live state's (monolithic ``VideoHybridNet`` names
        against the pipelined ``rest.``/``stages.`` ones, or pipelined over
        another number of stages), the parameters, BatchNorm stats,
        optimizer moments and EMA are read whole, converted into the live
        layout and cut to this rank's slices; moments or an EMA that do not
        map (another optimizer, a weights-only checkpoint, a run without an
        EMA) start fresh, the EMA from the converted weights, and each is
        counted as a reset, a missing one too (JAX's ``_overlay_opt_state``
        leaves a missing one uncounted). With the same layout the restore's
        own error re-raises."""
        from tchvp_tpu_torch.parallel import pipeline as ppl

        try:
            raw = ckpt.restore_state(path)
        except Exception as err2:
            raise err2 from err
        disk_pp = ppl.is_pipelined_params(raw["model"])
        live_pp = ppl.is_pipelined_params(self.state.model.state_dict())
        same_grouping = not (disk_pp and live_pp) or (
            raw["model"]["stages.norm.weight"].shape[1:] == self.state.model.stages.norm.weight.shape[1:])
        if disk_pp == live_pp and same_grouping:
            raise err  # not a layout change: a genuine restore failure
        num_layers = self.state.model.config.temporal.num_layers

        def conv(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
            """Disk layout -> live layout of a dict of the model's names."""
            t = ppl.merge_pipelined_params(tree, num_layers) if disk_pp else tree
            if live_pp:
                return ppl.pipelined_layout(t, num_layers, self.state.model.n_stages)
            return t

        raw["model"] = conv(raw["model"])
        stats = {"converted": 0, "reset": 0}
        trainable = {n for n, p in self.state.tx.named.items()
                     if any(p is q for q in self.state.tx.trainable)}
        opt = raw.setdefault("opt_state", {"moments": None, "count": 0, "notfinite_count": 0, "ema": None})
        if opt["moments"] is None:  # a weights-only checkpoint: fresh moments
            stats["reset"] += 1
            opt["moments"] = {}
        else:
            try:
                opt["moments"] = _convert_moments(opt["moments"], conv, trainable)
                if set(opt["moments"]) != trainable and (opt["moments"] or opt["count"]):
                    raise ValueError("moments do not cover the live trainable parameters")
                stats["converted"] += 1
            except (KeyError, ValueError, RuntimeError):
                stats["reset"] += 1
                opt["moments"] = {}
                opt["count"] = 0
        ema = opt.get("ema") if self.state.tx.ema is not None else None
        try:
            if ema is None:
                raise KeyError("ema")
            opt["ema"] = conv(ema)
            stats["converted"] += 1
        except (KeyError, ValueError, RuntimeError):
            # The live EMA starts from the converted weights; counted where
            # the live state keeps one (JAX counts no missing one).
            stats["reset"] += self.state.tx.ema is not None
            opt["ema"] = ({n: raw["model"][n].clone() for n in self.state.tx.named}
                          if self.state.tx.ema is not None else None)
        if ckpt.is_sharded_state(self.state):
            raw = ckpt._live_slices(self.state, raw)
        self.state = ckpt.load_payload(self.state, raw)
        layout = lambda pp: "pipelined" if pp else "monolithic"  # noqa: E731
        print(f"[resume] checkpoint layout {layout(disk_pp)} -> live {layout(live_pp)}: parameters and "
              f"batch stats converted; optimizer state: {stats['converted']} parts converted, "
              f"{stats['reset']} reset")
        return raw

    def _ckpt_extra(self, epoch: int, data: Any) -> dict:
        extra = {"train_epoch": epoch}
        if hasattr(data, "position"):
            extra["data_position"] = data.position()
        return extra

    def _save(self, tag: int, epoch: int, data: Any) -> None:
        """Rank 0 saves a replicated state; every rank saves its slices of a
        sharded one (module docstring)."""
        if _rank() != 0 and not ckpt.is_sharded_state(self.state):
            return
        ckpt.save_state(self.cfg.checkpoint_dir, tag, self.state,
                        extra=self._ckpt_extra(epoch, data),
                        async_write=self.cfg.async_checkpoint)
        if _rank() == 0:
            ckpt.prune_step_dirs(self.cfg.checkpoint_dir, self.cfg.keep_checkpoints)

    def train(
        self,
        train_data: Iterable,
        epochs: int = 10,
        clip_len: int = 8,
        start_epoch: int = 0,
        save_every: int = 10,
        save_every_steps: int = 0,
        health: Optional[HealthMonitor] = None,
    ) -> TrainState:
        """``health``: optional :class:`HealthMonitor`; on sustained NaN
        loss the flow restores the latest step-tagged checkpoint (or
        raises :class:`TrainingDiverged` when none exists).

        ``save_every_steps`` > 0 also checkpoints every N batches WITHIN an
        epoch, tagging checkpoints by global batch count
        ``(epoch-1)*len(data)+i``; epoch-end saves then use the same
        numbering so ``latest_step_dir`` stays monotone. Each save records
        the dataset ``position()`` (when available) so :meth:`resume` can
        seek mid-epoch. Requires a sized ``train_data``."""
        train_data = self._prefetched(self._local(train_data, self.accum_steps))
        if save_every_steps and not hasattr(train_data, "__len__"):
            raise ValueError(
                "save_every_steps needs a sized dataset (len()) for "
                "monotone checkpoint tags"
            )
        spe = len(train_data) if hasattr(train_data, "__len__") else 0
        # Tag numbering must not mix within one directory ("steps" and
        # "epochs" tags compare numerically in latest_step_dir).
        if _rank() == 0:
            ckpt.ensure_tag_scheme(self.cfg.checkpoint_dir,
                                   "steps" if save_every_steps else "epochs")
        if self.state is None:
            self.init_state(clip_len)
        for epoch in range(start_epoch + 1, epochs + 1):
            sums: Optional[Dict[str, torch.Tensor]] = None
            n = 0
            # Epoch-start offset into the data epoch: nonzero after a
            # mid-epoch resume (the iterator serves only the remainder).
            pos0 = (
                train_data.position()["batch"]
                if save_every_steps and hasattr(train_data, "position")
                else 0
            )
            for batch in train_data:
                self.state, m = self._train_step(self.state, self._shard(batch))
                sums = _epoch_sums(sums, m)
                if health is not None:
                    loss = float(m["loss"])
                    status = health.check(loss)
                    if status == "spike":
                        print(f"[health] loss spike at epoch {epoch}: "
                              f"{loss:.4f} vs ema {health.ema:.4f}")
                    if health.diverged:
                        self.state, step = recover_latest(self.state, self.cfg.checkpoint_dir)
                        if step is None:
                            raise TrainingDiverged(
                                f"NaN loss for {health.nan_tolerance} steps "
                                f"and no checkpoint to restore"
                            )
                        print(f"[health] diverged; restored checkpoint step {step}")
                        health.consecutive_nan = 0
                n += 1
                if save_every_steps:
                    # Absolute index within the data epoch (survives a
                    # mid-epoch resume) -> globally monotone tags. Not
                    # position()["batch"]: that normalizes to 0 on the
                    # epoch-final batch (it reports the NEXT batch).
                    abs_i = pos0 + n
                    if abs_i % save_every_steps == 0:
                        self._save((epoch - 1) * spe + abs_i, epoch, train_data)
            train_m = _mean_of(_host_sums(sums, ("loss", "psnr")), n)
            self._log("Loss/Train", train_m["loss"], epoch)
            self._log("PSNR/Train", train_m["psnr"], epoch)
            extra = ""
            for k in sorted(train_m):
                if k in ("loss", "psnr"):
                    continue
                tag = "".join(p.capitalize() for p in k.split("_"))
                self._log(f"{tag}/Train", train_m[k], epoch)
                extra += f" {k} {train_m[k]:.4f}"
            print(
                f"Video epoch {epoch}: loss {train_m['loss']:.4f} "
                f"PSNR {train_m['psnr']:.2f}" + extra
            )
            # Skip the epoch-end save when the step cadence just wrote
            # the identical state under the identical tag (epoch*spe).
            boundary_covered = bool(save_every_steps) and spe % save_every_steps == 0
            if epoch % save_every == 0 and not boundary_covered:
                self._save(epoch * spe if save_every_steps else epoch, epoch, train_data)
        # A finished run never ends checkpoint-less: when the final epoch
        # missed both cadences, save the final state now.
        final_covered = (
            epochs <= start_epoch
            or (bool(save_every_steps) and spe % save_every_steps == 0)
            or epochs % save_every == 0
        )
        if not final_covered:
            self._save(epochs * spe if save_every_steps else epochs, epochs, train_data)
        ckpt.wait_for_async_saves()
        if self.writer is not None:
            self.writer.flush()
        return self.state


class SegmentationFlow(_FlowBase):
    """Image -> mask training and working inference (FCT_FLOW semantics).

    ``model``: an initialised segmentation model; the flow runs on the
    model's device. Batches are
    ``(images_u8 (B, H, W, 3), masks_u8 (B, H, W, 1))``. ``loss_history``
    holds each epoch's summed training loss, as the reference's checkpoint
    carries it (``FCT.py:368-373``); :meth:`restore` brings it back and
    sets ``start_epoch``, where :meth:`train` continues."""

    def __init__(
        self,
        model: torch.nn.Module,
        cfg: TrainConfig = TrainConfig(model_name="FCT", loss="dice", lr=1e-3),
        image_size: int = 256,
        mesh=None,
        sp_axis: Optional[str] = None,
    ):
        _check_sp_axis(model, sp_axis)
        super().__init__(cfg, mesh, next(model.parameters()).device)
        self.model = model
        self.image_size = image_size
        self.state: Optional[TrainState] = None
        self.loss_history: list = []
        self.start_epoch: int = 0
        self._train_step = self._under_mesh(steps_lib.make_segmentation_train_step(image_size, cfg.loss))
        self._eval_step = self._under_mesh(steps_lib.make_segmentation_eval_step(image_size, cfg.loss))

    def init_state(self, lr: Optional[float] = None) -> TrainState:
        """A step-0 state over the model as it stands, its generators
        seeded from ``cfg.seed``."""
        self.state = create_train_state(self.model, self._optimizer(lr), rng=self.cfg.seed)
        return self.state

    def train(
        self,
        train_data: Iterable,
        test_data: Optional[Iterable] = None,
        epochs: int = 70,
        lr: Optional[float] = None,
        start_epoch: Optional[int] = None,
    ) -> TrainState:
        """``start_epoch`` defaults to where :meth:`restore` left off, so
        restore() + train() continues the epoch numbering, the checkpoints
        and the loss history. ``test_data`` is unused, as in JAX. Each
        epoch saves one sneak peek of a batch drawn from
        ``np.random.default_rng(cfg.seed)``, and checkpoints (tag: the
        epoch) when its summed loss is the lowest so far."""
        cfg = self.cfg
        del test_data
        train_data = self._prefetched(self._local(train_data))
        if self.state is None:
            self.init_state(lr)
        if start_epoch is None:
            start_epoch = self.start_epoch
        # A restored history seeds best-loss so a worse first epoch after
        # resume does not replace the best checkpoint.
        best_loss = min(self.loss_history) if self.loss_history else float("inf")
        rng = np.random.default_rng(cfg.seed)
        for epoch in range(start_epoch + 1, epochs + 1):
            sums: Optional[Dict[str, torch.Tensor]] = None
            n = 0
            nbatches = len(train_data) if hasattr(train_data, "__len__") else None
            sneak = rng.integers(0, nbatches) if nbatches else 0
            for i, batch in enumerate(train_data):
                placed = self._shard(batch)
                self.state, m = self._train_step(self.state, placed)
                sums = _epoch_sums(sums, m)
                n += 1
                if i == sneak and _rank() == 0:  # per-epoch sneak peek (FCT.py:339-340)
                    self._save_sneakpeek(epoch, placed)
            host = _host_sums(sums, ("loss", "iou"))
            train_m = _mean_of(host, n)
            self.loss_history.append(host["loss"])
            self._log("Training Loss", host["loss"], epoch)  # FCT.py:356 (the sum)
            print(f"Epoch {epoch}: dice loss {train_m['loss']:.4f} IoU {train_m['iou']:.3f}")
            if host["loss"] < best_loss and _rank() == 0:  # best-train-loss checkpoint (FCT.py:366-373)
                ckpt.save_state(cfg.checkpoint_dir, epoch, self.state,
                                extra={"loss": host["loss"],
                                       "loss_history": torch.tensor(self.loss_history,
                                                                    dtype=torch.float64)},
                                async_write=cfg.async_checkpoint)
                ckpt.prune_step_dirs(cfg.checkpoint_dir, cfg.keep_checkpoints)
            best_loss = min(best_loss, host["loss"])
        ckpt.wait_for_async_saves()
        if self.writer is not None:
            self.writer.flush()
        return self.state

    def _predict(self, x: torch.Tensor) -> torch.Tensor:
        model = self.state.model.eval()
        with torch.no_grad():
            return model(x)

    def _save_sneakpeek(self, epoch: int, batch) -> None:
        image_u8, mask_u8 = batch
        x = pipeline.preprocess_images(image_u8[:1], self.image_size)
        y = pipeline.preprocess_images(mask_u8[:1], self.image_size)
        pred = self._predict(x)
        save_sample_triplet(os.path.join(self.cfg.sample_dir, self.cfg.model_name), epoch,
                            *(t.float().cpu().numpy() for t in (x, y, pred)))

    def evaluate(self, data: Iterable) -> dict:
        """Mean loss and IoU over an (image, mask) dataset."""
        sums, n = None, 0
        for batch in self._local(data):
            sums = _epoch_sums(sums, self._eval_step(self.state, self._shard(batch)))
            n += 1
        return _mean_of(_host_sums(sums, ("loss", "iou")), n)

    def restore(self, path: str) -> None:
        """Full resume: parameters, optimizer moments, generators and the
        loss history; ``start_epoch`` becomes the checkpoint's tag."""
        self.init_state()
        self.state, raw = ckpt.restore_state_into(self.state, path)
        hist = (raw.get("extra") or {}).get("loss_history")
        if hist is not None:
            self.loss_history = [float(v) for v in torch.as_tensor(hist).reshape(-1)]
        self.start_epoch = int(raw.get("step", 0))

    def infer(self, batch: np.ndarray, out_dir: Optional[str] = None) -> np.ndarray:
        """uint8 images (B, H, W, 3) -> masks (B, S, S, 1) in [0, 1] as
        numpy, with input | Sobel-edge side-by-side JPEGs in ``out_dir``."""
        x = pipeline.preprocess_images(torch.as_tensor(batch).to(self.device), self.image_size)
        pred = self._predict(x)
        edges = sobel_edges(pred)
        if out_dir:
            xs, es = x.cpu().numpy(), edges.cpu().numpy()
            for i in range(pred.shape[0]):
                save_side_by_side([xs[i], es[i]], os.path.join(out_dir, f"image_{i}.jpg"))
        return pred.float().cpu().numpy()


class DenoisingFlow(_FlowBase):
    """Image -> image denoising and inpainting AE training (Model.py
    semantics). ``model``: an initialised AE returning ``(latent, recon)``
    (:class:`AutoEncoder` by default in the CLI); the flow runs on its
    device. Batches are uint8 images (B, H, W, 3)."""

    def __init__(
        self,
        model: torch.nn.Module,
        cfg: TrainConfig = TrainConfig(),
        image_size: int = 256,
        aug: AugmentConfig = AugmentConfig(),
        mesh=None,
    ):
        super().__init__(cfg, mesh, next(model.parameters()).device)
        self.model = model
        self.image_size = image_size
        self.aug = aug
        self.state: Optional[TrainState] = None
        self._train_step = self._under_mesh(steps_lib.make_denoising_train_step(
            image_size, aug, cfg.loss, cfg.mixed_alpha, cfg.mixed_beta,
            data_range=cfg.mixed_data_range))
        self._eval_step = self._under_mesh(steps_lib.make_denoising_eval_step(image_size))
        self._test_step = self._under_mesh(steps_lib.make_inpainting_test_step(image_size, aug))

    def init_state(self, lr: Optional[float] = None) -> TrainState:
        """A step-0 state over the model as it stands, its generators
        seeded from ``cfg.seed``."""
        self.state = create_train_state(self.model, self._optimizer(lr), rng=self.cfg.seed)
        return self.state

    def fit(
        self,
        train_data: Iterable,
        val_data: Iterable,
        test_data: Optional[Iterable] = None,
        epochs: Optional[int] = None,
        lr: Optional[float] = None,
    ) -> TrainState:
        """Train ``epochs`` epochs (default ``cfg.epochs``). Each epoch is
        validated; the best validation PSNR so far saves the weights file
        ``<checkpoint_dir>/<model_name>`` (Model.py:181-182); every
        ``cfg.save_every`` epochs the full state goes to ``step_<epoch>``
        and ``test_data``, when given, is tested (Model.py:184-188)."""
        cfg = self.cfg
        epochs = epochs or cfg.epochs
        train_data = self._prefetched(self._local(train_data))
        if self.state is None:
            self.init_state(lr)
        print(f"Total parameters: {human_param_count(param_count(self.state.model))}")
        best_val_psnr = -float("inf")
        for epoch in range(1, epochs + 1):
            t0 = time.time()
            sums: Optional[Dict[str, torch.Tensor]] = None
            n = 0
            for batch in train_data:
                self.state, m = self._train_step(self.state, self._shard(batch))
                sums = _epoch_sums(sums, m)
                n += 1
            train_m = _mean_of(_host_sums(sums, ("loss", "psnr")), n)
            val_psnr = self.validate(val_data)
            self._log("Loss/Train", train_m["loss"], epoch)
            self._log("PSNR/Train", train_m["psnr"], epoch)
            self._log("PSNR/Val", val_psnr, epoch)
            print(f"Epoch {epoch}: loss {train_m['loss']:.4f} train PSNR {train_m['psnr']:.2f} "
                  f"val PSNR {val_psnr:.2f} ({time.time() - t0:.1f}s)")
            if val_psnr > best_val_psnr:  # best-val weights (Model.py:181-182)
                best_val_psnr = val_psnr
                if _rank() == 0:
                    ckpt.save_params(cfg.checkpoint_dir, cfg.model_name, self.state.model)
            if epoch % cfg.save_every == 0:  # periodic state + test (Model.py:184-188)
                if _rank() == 0:
                    ckpt.save_state(cfg.checkpoint_dir, epoch, self.state,
                                    extra={"best_val_psnr": best_val_psnr},
                                    async_write=cfg.async_checkpoint)
                    ckpt.prune_step_dirs(cfg.checkpoint_dir, cfg.keep_checkpoints)
                if test_data is not None:
                    self._log("PSNR/Test", self.test(test_data, epoch), epoch)
        ckpt.wait_for_async_saves()
        if self.writer is not None:
            self.writer.flush()
        return self.state

    def validate(self, val_data: Iterable) -> float:
        """Mean eval-mode reconstruction PSNR over ``val_data``."""
        sums, n = None, 0
        for batch in self._local(val_data):
            sums = _epoch_sums(sums, self._eval_step(self.state, self._shard(batch)))
            n += 1
        return _host_sums(sums, ("psnr",))["psnr"] / max(n, 1)

    def test(self, test_data: Iterable, epoch: int = 0) -> float:
        """Blackout-inpainting PSNR over ``test_data`` (Model.py:96-135),
        the blackouts drawn from a generator seeded ``cfg.seed + epoch``;
        one batch, picked by ``np.random.default_rng(cfg.seed + epoch)``,
        saves its first corrupted | predicted pair as
        ``<sample_dir>/<model_name>/<epoch>.jpg``."""
        generator = torch.Generator(self.device).manual_seed(self.cfg.seed + epoch)
        sample_at = (
            int(np.random.default_rng(self.cfg.seed + epoch).integers(len(test_data)))
            if hasattr(test_data, "__len__") and len(test_data) > 0
            else 0
        )
        sums, n = None, 0
        for i, batch in enumerate(self._local(test_data)):
            m, corrupted, pred = self._test_step(self.state, self._shard(batch), generator)
            sums = _epoch_sums(sums, m)
            n += 1
            if i == sample_at and _rank() == 0:
                save_side_by_side(
                    [corrupted[0].float().cpu().numpy(), pred[0].float().cpu().numpy()],
                    os.path.join(self.cfg.sample_dir, self.cfg.model_name, f"{epoch}.jpg"))
        return _host_sums(sums, ("psnr",))["psnr"] / max(n, 1)

    def infer(self, batch: np.ndarray) -> np.ndarray:
        """uint8 (B, H, W, 3) -> the eval-mode reconstruction (B, S, S, 3)."""
        clean = pipeline.preprocess_images(torch.as_tensor(batch).to(self.device), self.image_size)
        model = self.state.model.eval()
        with torch.no_grad():
            return model(clean)[1].float().cpu().numpy()


class TransferFlow(_FlowBase):
    """Frozen-encoder latent -> mask transfer (recovered AE_32K L222-326).

    Builds ``Autoencoder32K(ResNetAEConfig(output_type="mask"))`` on
    ``device``, its weights from a generator seeded ``cfg.seed``; loads a
    pretrained ``Autoencoder32K``'s encoder parameters, freezes the encoder
    and trains the fresh mask decoder with dice. The frozen encoder runs in
    train mode, so its BatchNorm normalises with batch statistics and its
    running stats move, as in JAX; its parameters get no gradient and no
    update. Per-epoch sneak peeks, :meth:`resume` from the latest
    checkpoint, :meth:`test_a_sample` previews."""

    def __init__(
        self,
        cfg: TrainConfig = TrainConfig(model_name="latent_to_mask", loss="dice"),
        image_size: int = 256,
        mesh=None,
        device: torch.device | str = "cuda",
    ):
        super().__init__(cfg, mesh, device)
        self.image_size = image_size
        self.model = Autoencoder32K(ResNetAEConfig(output_type="mask"), device=self.device,
                                    generator=torch.Generator().manual_seed(cfg.seed))
        self.state: Optional[TrainState] = None
        # Autoencoder32K returns (latent, mask): output 1 goes to the loss.
        self._train_step = self._under_mesh(steps_lib.make_segmentation_train_step(image_size, cfg.loss,
                                                                                   output_index=1))

    def init_from_pretrained(self, pretrained_params_path: Optional[str] = None,
                             lr: float = 1e-3) -> TrainState:
        """A step-0 state whose optimizer leaves ``encoder`` out
        (``frozen_prefixes``), the encoder's parameters from the checkpoint
        at ``pretrained_params_path`` when given (``restore_subtree``; a
        ``port --model ae32k`` output, or any checkpoint of an
        ``Autoencoder32K``). As JAX's ``restore_subtree`` takes the params
        tree only, the encoder's BatchNorm running stats are not carried
        over: they start at (0, 1)."""
        self.state = create_train_state(self.model, self._optimizer(lr, ("encoder",)),
                                        rng=self.cfg.seed)
        if pretrained_params_path:
            sub = ckpt.restore_subtree(pretrained_params_path, ("encoder",))["encoder"]
            params = dict(self.model.encoder.named_parameters())
            missing = sorted(set(params) - set(sub))
            if missing:
                raise ValueError(f"pretrained encoder lacks parameters: {missing[:5]}")
            with torch.no_grad():
                for name, p in params.items():
                    p.copy_(sub[name])
        self.model.encoder.requires_grad_(False)
        return self.state

    def resume(self) -> int:
        """Restore the latest checkpoint under ``cfg.checkpoint_dir`` (model,
        moments, generators) in place; returns the start epoch (0 if none)."""
        assert self.state is not None, "call init_from_pretrained first"
        path = ckpt.latest_step_dir(self.cfg.checkpoint_dir)
        if path is None:
            return 0
        self.state, raw = ckpt.restore_state_into(self.state, path)
        return int(raw.get("step", 0))

    def train(self, train_data: Iterable, epochs: int = 10, start_epoch: int = 0) -> TrainState:
        """Epochs ``start_epoch + 1`` .. ``epochs``: each saves one sneak peek
        of a batch drawn from ``np.random.default_rng(cfg.seed)`` and
        checkpoints (tag: the epoch) when its summed dice loss is the lowest
        of this call."""
        assert self.state is not None, "call init_from_pretrained first"
        train_data = self._prefetched(self._local(train_data))
        best_loss = float("inf")
        rng = np.random.default_rng(self.cfg.seed)
        for epoch in range(start_epoch + 1, epochs + 1):
            sums: Optional[Dict[str, torch.Tensor]] = None
            n = 0
            nbatches = len(train_data) if hasattr(train_data, "__len__") else None
            sneak = rng.integers(0, nbatches) if nbatches else 0
            for i, batch in enumerate(train_data):
                placed = self._shard(batch)
                self.state, m = self._train_step(self.state, placed)
                sums = _epoch_sums(sums, m)
                n += 1
                if i == sneak and _rank() == 0:  # per-epoch sneak peek (AE_32K L292-293)
                    self._save_sneakpeek(epoch, placed)
            host = _host_sums(sums, ("loss", "iou"))
            self._log("Training Loss", host["loss"], epoch)
            print(f"Transfer epoch {epoch}: dice {_mean_of(host, n)['loss']:.4f}")
            if host["loss"] < best_loss and _rank() == 0:  # best-loss checkpoint (AE_32K L299-306)
                ckpt.save_state(self.cfg.checkpoint_dir, epoch, self.state,
                                async_write=self.cfg.async_checkpoint)
                ckpt.prune_step_dirs(self.cfg.checkpoint_dir, self.cfg.keep_checkpoints)
            best_loss = min(best_loss, host["loss"])
        ckpt.wait_for_async_saves()
        if self.writer is not None:
            self.writer.flush()
        return self.state

    def _predict(self, image_u8: torch.Tensor):
        x = pipeline.preprocess_images(torch.as_tensor(image_u8).to(self.device), self.image_size)
        model = self.state.model.eval()
        with torch.no_grad():
            return x, model(x)[1]  # (latent, mask) -> mask

    def _save_sneakpeek(self, epoch: int, batch) -> None:
        """Input | mask | prediction JPEGs (AE_32K save_sample, L194-202)."""
        image_u8, mask_u8 = batch
        x, pred = self._predict(image_u8[:1])
        y = pipeline.preprocess_images(mask_u8[:1], self.image_size)
        save_sample_triplet(os.path.join(self.cfg.sample_dir, self.cfg.model_name), epoch,
                            *(t.float().cpu().numpy() for t in (x, y, pred)))

    def test_a_sample(self, data: Iterable, batch_size: int = 4,
                      out_dir: Optional[str] = None) -> np.ndarray:
        """One-shot preview (AE_32K test_a_sample, L313-326): the first
        ``batch_size`` images of ``data``'s first batch, input | prediction
        panels in ``out_dir`` (default ``<sample_dir>/<model_name>_test``);
        returns the masks."""
        assert self.state is not None, "no state; train or resume first"
        batch = next(iter(data))
        image_u8 = batch[0] if isinstance(batch, (tuple, list)) else batch
        x, pred = self._predict(image_u8[:batch_size])
        out_dir = out_dir or os.path.join(self.cfg.sample_dir, self.cfg.model_name + "_test")
        xs, ps = x.float().cpu().numpy(), pred.float().cpu().numpy()
        for i in range(ps.shape[0]):
            save_side_by_side([xs[i], ps[i]], os.path.join(out_dir, f"sample_{i}.jpg"))
        return ps
