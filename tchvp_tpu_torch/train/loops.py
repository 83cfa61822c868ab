"""Training and evaluation flows (survey layer L5).

Counterpart of ``tchvp_tpu/train/loops.py``'s :class:`VideoFlow` (with
``_FlowBase`` and ``_mean_of`` behind it): clip-denoising training of the
flagship with periodic step-tagged checkpoints, resume (mid-epoch too),
TensorBoard-compatible logging and the loss-health monitor; and its
:class:`SegmentationFlow`: image -> mask training of FCT with per-epoch
sneak peeks, the best-train-loss checkpoint carrying the loss history,
restore that continues the epoch numbering, and inference with Sobel
edges. The other flows (``DenoisingFlow``, ``TransferFlow``) come with the
other model families (ROADMAP.md, modules to port, item 7).

The flow runs on the device its model lives on. Datasets yield uint8
numpy batches (synthetic, CSV manifests, clippacks); :meth:`_shard` places
each one on that device, through :class:`DevicePrefetch` when
``TrainConfig.device_prefetch`` > 0. Under a ``seq`` mesh every rank is
given the global clip, and the step takes the rank's frames after drawing
the input noise at the global shape (``train/steps.py``), so the flow
itself only places.

Host syncs. JAX's loop reads every metric on the host after every step.
Here the per-epoch sums stay on the device, in float64, and are read once
at the epoch's end: the same values as a per-step read summed in Python
floats (float64, same order). Only the health monitor reads the loss each
step, when one is given.

Under a mesh of several ranks the parameters stay bit-equal across ranks
(``train/steps.py``), so rank 0 alone writes checkpoints, the TAG_SCHEME
marker and the event files; every rank computes the same tags.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

from tchvp_tpu_torch.config import AugmentConfig, TrainConfig
from tchvp_tpu_torch.data import pipeline
from tchvp_tpu_torch.data.device_prefetch import DevicePrefetch
from tchvp_tpu_torch.ops.sobel import sobel_edges
from tchvp_tpu_torch.parallel import activate_mesh
from tchvp_tpu_torch.train import checkpoint as ckpt
from tchvp_tpu_torch.train import steps as steps_lib
from tchvp_tpu_torch.train.health import HealthMonitor, TrainingDiverged, recover_latest
from tchvp_tpu_torch.train.logging import SummaryWriter
from tchvp_tpu_torch.train.state import TrainState, create_train_state, make_optimizer
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

    def _shard(self, batch) -> torch.Tensor:
        """The batch on the flow's device (a no-op for a placed batch)."""
        return torch.as_tensor(batch).to(self.device)

    def _under_mesh(self, fn: Callable) -> Callable:
        """``fn`` run inside ``activate_mesh(self.mesh)``: the sequence-
        parallel paths read the ambient mesh."""
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

    def _optimizer(self, lr: Optional[float]):
        cfg = self.cfg
        return make_optimizer(lr or cfg.lr, cfg.weight_decay, grad_clip_norm=1.0,
                              schedule=cfg.schedule, warmup_steps=cfg.warmup_steps,
                              total_steps=cfg.total_steps, min_lr_ratio=cfg.min_lr_ratio,
                              ema_decay=cfg.ema_decay, optimizer=cfg.optimizer)


def _epoch_sums(sums: Optional[Dict[str, torch.Tensor]], m: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
    """``m`` added into float64 sums on its device (made at the first
    step); read on the host once per epoch."""
    if sums is None:
        sums = {k: torch.zeros((), dtype=torch.float64, device=v.device) for k, v in m.items()}
    for k, s in sums.items():
        s += m[k].detach().double()
    return sums


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
    ):
        super().__init__(cfg, mesh, next(model.parameters()).device)
        if pipe_axis:
            raise NotImplementedError(
                "pipe_axis (pipelined training) is not ported yet "
                "(ROADMAP.md, modules to port, item 11: parallel/pipeline.py)")
        if sp_axis:
            raise NotImplementedError(
                "sp_axis (spatial partitioning) is not ported yet "
                "(ROADMAP.md, modules to port, item 11: parallelism)")
        if seq_axis is not None and seq_axis != model.config.temporal.seq_axis:
            raise ValueError(f"seq_axis={seq_axis!r} must match the model config's "
                             f"temporal.seq_axis={model.config.temporal.seq_axis!r}")
        self.model = model
        self.image_size = image_size
        self.state: Optional[TrainState] = None
        self.seq_axis = seq_axis
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
        seeded from ``cfg.seed``. ``clip_len`` is kept for the JAX
        signature (flax needs an example input to initialise)."""
        del clip_len
        self.state = create_train_state(self.model, self._optimizer(lr), rng=self.cfg.seed)
        return self.state

    def evaluate(self, data: Iterable) -> float:
        """Mean reconstruction PSNR over a clip dataset."""
        total, n = None, 0
        for batch in data:
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
        checkpoint of another layout fails with the restore's own error
        (the JAX package's layout-elastic resume needs item 11)."""
        path = ckpt.latest_step_dir(self.cfg.checkpoint_dir)
        if path is None:
            return 0
        if self.state is None:
            self.init_state(clip_len)
        self.state, raw = ckpt.restore_state_into(self.state, path)
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

    def _ckpt_extra(self, epoch: int, data: Any) -> dict:
        extra = {"train_epoch": epoch}
        if hasattr(data, "position"):
            extra["data_position"] = data.position()
        return extra

    def _save(self, tag: int, epoch: int, data: Any) -> None:
        if _rank() != 0:
            return
        ckpt.save_state(self.cfg.checkpoint_dir, tag, self.state,
                        extra=self._ckpt_extra(epoch, data),
                        async_write=self.cfg.async_checkpoint)
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
        train_data = self._prefetched(train_data)
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
            host = {k: float(v) for k, v in sums.items()} if sums else {"loss": 0.0, "psnr": 0.0}
            train_m = _mean_of(host, n)
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
        if mesh is not None or sp_axis:
            raise NotImplementedError(
                "meshes and sp_axis (spatial partitioning) for segmentation are not ported yet "
                "(ROADMAP.md, modules to port, item 11: parallelism)")
        super().__init__(cfg, mesh, next(model.parameters()).device)
        self.model = model
        self.image_size = image_size
        self.state: Optional[TrainState] = None
        self.loss_history: list = []
        self.start_epoch: int = 0
        self._train_step = steps_lib.make_segmentation_train_step(image_size, cfg.loss)
        self._eval_step = steps_lib.make_segmentation_eval_step(image_size, cfg.loss)

    def init_state(self, lr: Optional[float] = None) -> TrainState:
        """A step-0 state over the model as it stands, its generators
        seeded from ``cfg.seed``."""
        self.state = create_train_state(self.model, self._optimizer(lr), rng=self.cfg.seed)
        return self.state

    def _shard(self, batch):
        """The (images, masks) pair on the flow's device."""
        return tuple(torch.as_tensor(b).to(self.device) for b in batch)

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
        train_data = self._prefetched(train_data)
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
                if i == sneak:  # per-epoch sneak peek (FCT.py:339-340)
                    self._save_sneakpeek(epoch, placed)
            host = {k: float(v) for k, v in sums.items()} if sums else {"loss": 0.0, "iou": 0.0}
            train_m = _mean_of(host, n)
            self.loss_history.append(host["loss"])
            self._log("Training Loss", host["loss"], epoch)  # FCT.py:356 (the sum)
            print(f"Epoch {epoch}: dice loss {train_m['loss']:.4f} IoU {train_m['iou']:.3f}")
            if host["loss"] < best_loss:  # best-train-loss checkpoint (FCT.py:366-373)
                best_loss = host["loss"]
                ckpt.save_state(cfg.checkpoint_dir, epoch, self.state,
                                extra={"loss": host["loss"],
                                       "loss_history": torch.tensor(self.loss_history,
                                                                    dtype=torch.float64)},
                                async_write=cfg.async_checkpoint)
                ckpt.prune_step_dirs(cfg.checkpoint_dir, cfg.keep_checkpoints)
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
        for batch in data:
            sums = _epoch_sums(sums, self._eval_step(self.state, self._shard(batch)))
            n += 1
        host = {k: float(v) for k, v in sums.items()} if sums else {"loss": 0.0, "iou": 0.0}
        return _mean_of(host, n)

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
