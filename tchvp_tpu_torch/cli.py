"""Explicit CLI entry points of the port.

Counterpart of ``tchvp_tpu/cli.py``, with its subcommand names and flags:

    python -m tchvp_tpu_torch.cli video  --synthetic 3 --attn-impl flash
    python -m tchvp_tpu_torch.cli video  --synthetic 3 --model ae32k
    python -m tchvp_tpu_torch.cli segment --synthetic 3
    python -m tchvp_tpu_torch.cli denoise --synthetic 3
    python -m tchvp_tpu_torch.cli port   --model ae32k --checkpoint AE_32K.tar --out ported
    python -m tchvp_tpu_torch.cli transfer --synthetic 3 --pretrained ported/step_0
    python -m tchvp_tpu_torch.cli eval   --model ae --checkpoint checkpoints/IMAGE2IMAGE
    python -m tchvp_tpu_torch.cli eval   --model fct --checkpoint checkpoints/step_2
    python -m tchvp_tpu_torch.cli video  --clippack clips.cpk --resume
    python -m tchvp_tpu_torch.cli infer  --checkpoint checkpoints/step_5
    python -m tchvp_tpu_torch.cli eval   --checkpoint checkpoints/step_5
    python -m tchvp_tpu_torch.cli stream --synthetic 2 --height 1080 --width 1920
    python -m tchvp_tpu_torch.cli infer  --int8 --checkpoint checkpoints/step_5
    python -m tchvp_tpu_torch.cli video  --synthetic 3 --qat --attn-impl flash
    python -m tchvp_tpu_torch.cli video  --synthetic 3 --num-experts 4 --attn-impl flash
    python -m tchvp_tpu_torch.cli infer  --num-experts 4 --checkpoint checkpoints/step_5
    python -m tchvp_tpu_torch.cli export --model fct --out fct.tchvp
    python -m tchvp_tpu_torch.cli serve  --exported fct.tchvp --buckets 1,2
    python -m tchvp_tpu_torch.cli infer  --url http://127.0.0.1:8765
    python -m tchvp_tpu_torch.cli pack   --train-csv clips.csv --out clips.cpk
    python -m tchvp_tpu_torch.cli summary --model hybrid
    python -m tchvp_tpu_torch.cli summary --model fct
    python -m tchvp_tpu_torch.cli summary --model combined
    python -m tchvp_tpu_torch.cli shards --model hybrid --mesh data=8 --fsdp
    python -m tchvp_tpu_torch.cli doctor --smoke

Every command that runs a model runs it on ``--device`` (default
``cuda``); without a card it exits 1 unless ``--device cpu`` is given.
``port``, ``summary`` and ``shards`` run no model: they build theirs on the
CPU (``shards`` on the ``meta`` device).

A mesh (``--mesh axis=N,...``; ``--data-parallel`` puts every rank on
``data``) runs as one process a rank, on one host or several. ``video``
takes any product of ``seq``, ``model``, ``expert`` and ``spatial``, with
or without ``data=``, and ``pipe`` beside ``data=`` alone, as JAX's
``video`` does (``seq`` with ``--window`` or ``--attn-impl ring``,
``expert`` with ``--num-experts``, ``--fsdp`` over ``data=``); ``segment``
takes ``data`` and ``spatial``, ``infer`` and ``serve`` ``data`` and
``pipe``, ``eval`` ``data`` and ``seq``, the other commands ``data``
alone (:func:`mesh_refusal`, the one rule). Every process gets the same
flags,
``--coordinator`` (``host:port`` of rank 0, or any ``torch.distributed``
init URL), ``--num-processes`` (the world) and its own ``--process-id``.
At the rendezvous the ranks learn which of them share a host
(``parallel.init_distributed``): a rank takes the card of its local rank,
and the backend is NCCL when every host has a card for each of its ranks,
else gloo. Rank 0 prints the launch in one line.
"""

from __future__ import annotations

import argparse
import math
import os
import subprocess
import sys
import time
from typing import Optional

def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--config", default=None,
                   help="YAML experiment config: a mapping of flag names "
                        "(dashes or underscores) to values, applied as "
                        "defaults for this subcommand — explicit CLI flags "
                        "still win. The resolved run is recorded to "
                        "<checkpoint-dir>/run.json for training commands")
    p.add_argument("--train-csv", default=None)
    p.add_argument("--val-csv", default=None)
    p.add_argument("--test-csv", default=None)
    p.add_argument("--synthetic", type=int, default=0, help="batches of synthetic data")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--loss", default=None)
    p.add_argument("--checkpoint-dir", default="checkpoints")
    p.add_argument("--data-parallel", action="store_true",
                   help="every launched rank on one data axis: each trains on its "
                        "block of the global batch (--coordinator, --num-processes, "
                        "--process-id)")
    p.add_argument("--optimizer", default="adamw",
                   choices=("adamw", "adam", "sgd", "lion"),
                   help="adamw = reference parity (FCT.py:305); lion = "
                        "half the optimizer-state memory (one moment)")
    p.add_argument("--schedule", default=None,
                   choices=("constant", "cosine"),
                   help="LR schedule (default: constant, reference parity)")
    p.add_argument("--warmup-steps", type=int, default=0)
    p.add_argument("--total-steps", type=int, default=0,
                   help="decay horizon for --schedule cosine")
    p.add_argument("--min-lr-ratio", type=float, default=0.0)
    p.add_argument("--ema-decay", type=float, default=0.0,
                   help="EMA parameter averaging decay (e.g. 0.999); "
                        "0 = off (reference parity)")
    p.add_argument("--async-checkpoint", action="store_true",
                   help="background checkpoint writes: the loop keeps "
                        "training while the save commits")
    p.add_argument("--keep-checkpoints", type=int, default=0,
                   help="keep only the newest N step checkpoints "
                        "(0 = keep all)")
    p.add_argument("--profile-dir", default=None,
                   help="capture a torch.profiler trace of the whole "
                        "command into this dir (trace.json, Perfetto)")
    p.add_argument("--device-prefetch", type=int, default=2,
                   help="keep N batches pre-placed on the device so the "
                        "host-to-device copy overlaps the running step "
                        "(data/device_prefetch.py); 0 disables")
    p.add_argument("--device", default="cuda",
                   help="torch device the command runs on (cuda, cuda:1, "
                        "cpu); no fallback: without a card a cuda device "
                        "exits 1")
    p.add_argument("--coordinator", default=None,
                   help="host:port of rank 0 (or a torch.distributed init "
                        "URL) for a multi-process launch")
    p.add_argument("--num-processes", type=int, default=1)
    p.add_argument("--process-id", type=int, default=0)
    p.add_argument("--rot90-prob", type=float, default=0.0,
                   help="per-sample k*90-degree rotation probability")
    p.add_argument("--crop-prob", type=float, default=0.0,
                   help="per-sample random-crop-resize probability")
    p.add_argument("--crop-frac", type=float, default=0.875,
                   help="crop fraction for --crop-prob")
    p.add_argument("--jitter-prob", type=float, default=0.0,
                   help="per-sample color-jitter probability")
    p.add_argument("--jitter-strength", type=float, default=0.2)


def _add_checkpoint_model_flags(p: argparse.ArgumentParser) -> None:
    """The training-config flags a checkpoint consumer mirrors to rebuild
    the matching model."""
    p.add_argument("--num-experts", type=int, default=0,
                   help="match the --num-experts the checkpoint was trained "
                        "with (a mismatch is rejected at load)")
    p.add_argument("--layers", type=int, default=2,
                   help="match the --layers the checkpoint was trained "
                        "with (temporal depth; a mismatch is rejected at load)")
    p.add_argument("--router-top-k", type=int, default=1,
                   help="match the training --router-top-k")


def _aug_cfg(args):
    """AugmentConfig with the beyond-reference knobs from the CLI."""
    from tchvp_tpu_torch.config import AugmentConfig

    return AugmentConfig(
        rot90_prob=args.rot90_prob,
        crop_prob=args.crop_prob,
        crop_frac=args.crop_frac,
        jitter_prob=args.jitter_prob,
        jitter_strength=args.jitter_strength,
    )


def _train_cfg_kwargs(args):
    """Shared TrainConfig fields from the common CLI flags."""
    return dict(
        optimizer=args.optimizer,
        schedule=args.schedule,
        warmup_steps=args.warmup_steps,
        total_steps=args.total_steps,
        min_lr_ratio=args.min_lr_ratio,
        ema_decay=args.ema_decay,
        async_checkpoint=args.async_checkpoint,
        keep_checkpoints=args.keep_checkpoints,
        device_prefetch=args.device_prefetch,
    )


def _config_defaults(path: str, p: argparse.ArgumentParser) -> dict:
    """Load a YAML experiment config as argparse defaults for subparser ``p``.

    Keys are flag names (dashes or underscores interchangeably); values get
    the flag's ``type`` coercion and ``choices`` validation, so a config
    error reads like the equivalent CLI error. Unknown keys list the valid
    ones.
    """
    try:
        import yaml
    except ImportError:
        raise SystemExit(f"--config {path}: reading a YAML config needs PyYAML "
                         "(the yaml module), which is not installed")

    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    if not isinstance(raw, dict):
        raise SystemExit(f"--config {path}: expected a mapping of flag: value")
    valid = {
        a.dest: a for a in p._actions
        if a.dest not in ("help", "fn", "config")
    }
    out = {}
    for key, val in raw.items():
        dest = str(key).replace("-", "_")
        if dest not in valid:
            raise SystemExit(
                f"--config {path}: unknown key {key!r} "
                f"(valid: {', '.join(sorted(valid))})"
            )
        act = valid[dest]
        if isinstance(act, (argparse._StoreTrueAction, argparse._StoreFalseAction)):
            if not isinstance(val, bool):
                raise SystemExit(
                    f"--config {path}: {key} expects true/false, got {val!r}"
                )
        elif act.type is not None and val is not None:
            try:
                val = act.type(val)
            except (TypeError, ValueError):
                raise SystemExit(
                    f"--config {path}: {key}={val!r} is not a valid "
                    f"{getattr(act.type, '__name__', act.type)}"
                )
        if act.choices is not None and val not in act.choices:
            raise SystemExit(
                f"--config {path}: {key}={val!r} not in "
                f"{tuple(act.choices)}"
            )
        out[dest] = val
    return out


def _record_run(args) -> None:
    """Write <checkpoint-dir>/run.json before training starts: resolved
    flags, the device, versions, git revision (utils/runrecord.py)."""
    from tchvp_tpu_torch.utils.runrecord import write_run_record

    write_run_record(args.checkpoint_dir, args, extra={"command": args.cmd})


def _parse_mesh_axes(spec: str) -> dict:
    """"data=4,seq=2" -> {"data": 4, "seq": 2} (ordered)."""
    axes: dict = {}
    for part in filter(None, (spec or "").split(",")):
        if "=" not in part:
            raise SystemExit(f"--mesh: expected axis=size, got {part!r}")
        k, v = part.split("=", 1)
        axes[k.strip()] = int(v)
    return axes


# The model-side axes each command runs beside ``data=`` (JAX's commands'
# axes); a command not named here runs ``data=`` alone.
COMMAND_AXES = {"video": ("seq", "model", "expert", "spatial", "pipe"), "segment": ("spatial",),
                "infer": ("pipe",), "serve": ("pipe",), "eval": ("seq",)}
MODEL_SIDE_AXES = ("seq", "model", "expert", "spatial")
# JAX's refusal of --fsdp without a mesh, in its words, then the port's item.
FSDP_NEEDS_A_MESH = ("--fsdp requires --data-parallel or --mesh (a mesh to shard parameters over) "
                     "[ROADMAP.md, item 11d]")


def mesh_refusal(args, axes: dict, world: int = 1) -> Optional[str]:
    """Why ``args.cmd`` refuses a mesh of ``axes`` (name -> size; an axis
    of size 1 is no axis) over ``world`` processes, or None where it runs
    it. Pure: the flags are ``args``, the command's parsed arguments.

    Every command refuses an axis it does not run (:data:`COMMAND_AXES`).
    ``video`` takes any product of ``seq``, ``model``, ``expert`` and
    ``spatial``, with or without ``data``, and ``pipe`` beside ``data``
    alone, refusing what JAX's ``cmd_video`` refuses, in its order and
    words: ``pipe`` off the hybrid or beside a model-side axis, with
    ``--qat`` or a remat policy but "full", or over a depth it does not
    divide; ``seq`` without ``--window`` or ``--attn-impl ring``;
    ``expert`` without ``--num-experts``; ``--fsdp`` without a mesh, which
    one process's ``--data-parallel`` or ``--mesh data=N`` is not (its mesh
    is dropped, as JAX's of one device). The port also refuses ``--fsdp``
    on a mesh without ``data`` (FSDP shards over it), which JAX's flow
    cannot run either (it needs a ``data`` axis in every mesh)."""
    cmd = args.cmd
    on = [k for k, v in axes.items() if v > 1]
    runs = ("data",) + COMMAND_AXES.get(cmd, ())
    others = sorted(k for k in on if k not in runs)
    if others:
        names = [f"{a}=" for a in runs]
        return f"{cmd}: unsupported mesh axes {others} ({cmd} supports {' and '.join(names)})"
    if cmd != "video":
        return None
    if "pipe" in on:
        if args.model != "hybrid":
            return "video: --mesh pipe=N needs --model hybrid (the temporal transformer is what pipelines)"
        beside = [a for a in MODEL_SIDE_AXES if a in on]
        if beside:
            return f"video: --mesh pipe=N composes with data= only (got {beside})"
        if args.qat or args.remat_policy not in ("none", "full"):
            return ("video: --mesh pipe=N does not compose with --qat, and only --remat-policy full "
                    "(checkpointed stage bodies) of the remat policies")
        if args.layers % axes["pipe"]:
            return f"video: --layers {args.layers} must be a multiple of pipe={axes['pipe']}"
    if "seq" in on and not args.window and args.attn_impl != "ring":
        return ("--mesh seq=N needs --window W (windowed/flash sequence parallelism) or --attn-impl ring "
                "(full attention)")
    if "expert" in on and not args.num_experts:
        return "--mesh expert=N needs --num-experts"
    if args.fsdp:
        if not on and not args.data_parallel:
            return FSDP_NEEDS_A_MESH
        if on and "data" not in on:
            return f"--fsdp shards over data=: give --mesh data=N beside {on} (the axis it shards over)"
        if world == 1 and (args.data_parallel or on == ["data"]):  # one process: no mesh to shard over
            return FSDP_NEEDS_A_MESH
    return None


def _mesh(args):
    """The mesh over the launched ranks, or None: the axes of ``--mesh``
    that :func:`mesh_refusal` lets ``args.cmd`` run, in the order given, as
    JAX's ``make_mesh`` (an axis of size 1 dropped); ``--data-parallel``
    puts every rank on ``data``."""
    import torch.distributed as dist

    from tchvp_tpu_torch.parallel import make_mesh

    axes = _parse_mesh_axes(getattr(args, "mesh", None) or "")
    world = dist.get_world_size() if dist.is_initialized() else 1
    refused = mesh_refusal(args, axes, world)
    if refused:
        raise SystemExit(refused)
    on = {k: v for k, v in axes.items() if v > 1}
    if getattr(args, "data_parallel", False):
        if on:
            raise SystemExit("--data-parallel puts every rank on data; give it or --mesh, not both")
        on = {"data": world}
    if not on or (list(on) == ["data"] and world == 1):
        return None
    n = math.prod(on.values())
    if world != n:
        raise SystemExit(
            f"--mesh {args.mesh}: {n} processes requested, {world} running "
            f"(launch one per rank with --coordinator, --num-processes {n} "
            f"and --process-id)")
    return make_mesh(tuple(on), tuple(on.values()))


def _cuda_check(args):
    """``--device`` as a torch device; a CUDA device must exist (no
    fallback)."""
    import torch

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device "
                         "(pass --device cpu to run on the CPU)")
    return dev


def _device(args):
    """``--device``, checked (:func:`_cuda_check`); a bare ``cuda`` is the
    card the launch gave this rank (``parallel.launch_layout``), card 0 in
    one process."""
    import torch

    from tchvp_tpu_torch.parallel import launch_layout

    dev = _cuda_check(args)
    if dev.type == "cuda":
        if dev.index is None:
            layout = launch_layout()
            dev = torch.device("cuda", 0 if layout is None else layout.card)
        torch.cuda.set_device(dev)
    return dev


def _image_data(args, supervised: bool = True):
    """(train, val, test) datasets of (image, mask) pairs, or of images
    alone when not ``supervised``: ``--synthetic N`` (seeds 0, 1, 2) or the
    CSV manifests (None where a manifest is not given)."""
    if args.synthetic:
        from tchvp_tpu_torch.data.synthetic import SyntheticImageMasks, SyntheticImages

        cls = SyntheticImageMasks if supervised else SyntheticImages
        return tuple(cls(args.batch_size, args.image_size, args.synthetic, seed)
                     for seed in (0, 1, 2))
    if not args.train_csv:
        raise SystemExit("provide --train-csv or --synthetic N")
    from tchvp_tpu_torch.data.manifest import ImageDataset, ImageMaskDataset

    cls = ImageMaskDataset if supervised else ImageDataset
    return tuple(cls(csv, args.batch_size, args.image_size, seed=seed, prefetch=True)
                 if csv else None
                 for csv, seed in ((args.train_csv, 0), (args.val_csv, 1), (args.test_csv, 2)))


def _fct_attn(args) -> str:
    """``--attn-impl`` of ``segment`` (default "auto": the flash kernels on
    a card); "ring" rides the ``spatial`` mesh axis."""
    return getattr(args, "attn_impl", None) or "auto"


def _fct_model(device, attn: str = "auto", sp_axis=None):
    """FCT at its default widths on ``device``, its weights from a seeded
    generator (seed 0); ``sp_axis``: its rows in blocks over that axis, the
    ring (``attn`` "ring") over it too, as JAX's ``segment`` builds it."""
    import torch

    from tchvp_tpu_torch.config import FCTConfig
    from tchvp_tpu_torch.models.fct import FCT

    config = FCTConfig(attn_impl=attn, sp_axis=sp_axis, seq_axis=sp_axis if attn == "ring" else None)
    return FCT(config, device=device, generator=torch.Generator().manual_seed(0))


def _seeded(model_cls, *a, **kw):
    """``model_cls`` with its weights from a generator seeded 0 (the JAX
    package's PRNGKey(0))."""
    import torch

    return model_cls(*a, generator=torch.Generator().manual_seed(0), **kw)


def _image_model(name: str, device):
    """The image families at their default widths on ``device``: "fct",
    "unet", "ae" (AutoEncoder) and "combined" (Image2Image2Mask)."""
    if name == "fct":
        return _fct_model(device)
    from tchvp_tpu_torch.models.autoencoder import AutoEncoder
    from tchvp_tpu_torch.models.combined import Image2Image2Mask
    from tchvp_tpu_torch.models.unet import UNet

    return _seeded({"unet": UNet, "ae": AutoEncoder, "combined": Image2Image2Mask}[name],
                   device=device)


def cmd_denoise(args) -> None:
    """Denoising-AE training (``DenoisingFlow``): the mixed loss by default,
    the best-val-PSNR weights file, a full checkpoint and an inpainting
    test every 5 epochs."""
    from tchvp_tpu_torch.config import TrainConfig
    from tchvp_tpu_torch.train.loops import DenoisingFlow

    cfg = TrainConfig(
        loss=args.loss or "mixed",
        lr=args.lr,
        checkpoint_dir=args.checkpoint_dir,
        batch_size=args.batch_size,
        **_train_cfg_kwargs(args),
    )
    train, val, test = _image_data(args, supervised=False)
    device = _device(args)
    flow = DenoisingFlow(_image_model("ae", device), cfg=cfg, image_size=args.image_size,
                         aug=_aug_cfg(args), mesh=_mesh(args))
    _record_run(args)
    flow.fit(train, val or train, test, epochs=args.epochs, lr=args.lr)


def cmd_transfer(args) -> None:
    """Frozen-encoder mask transfer (``TransferFlow``): the encoder of the
    ``--pretrained`` Autoencoder32K checkpoint under a fresh mask decoder,
    dice loss."""
    from tchvp_tpu_torch.config import TrainConfig
    from tchvp_tpu_torch.train.loops import TransferFlow

    cfg = TrainConfig(
        model_name="latent_to_mask",
        loss="dice",
        checkpoint_dir=args.checkpoint_dir,
        **_train_cfg_kwargs(args),
    )
    train, _, _ = _image_data(args, supervised=True)
    device = _device(args)
    flow = TransferFlow(cfg=cfg, image_size=args.image_size, device=device, mesh=_mesh(args))
    flow.init_from_pretrained(args.pretrained, lr=args.lr)
    _record_run(args)
    flow.train(train, epochs=args.epochs)


def cmd_port(args) -> None:
    """Convert a reference PyTorch checkpoint into a checkpoint of the
    port's model of that family (``utils/torch_port.py``), saved as
    ``<out>/step_0``: how a user of the reference brings their weights
    across, and what ``transfer --pretrained`` reads. Runs on the CPU."""
    from tchvp_tpu_torch import convert
    from tchvp_tpu_torch.train import checkpoint as ckpt
    from tchvp_tpu_torch.utils import torch_port

    if not args.checkpoint or not args.out:
        raise SystemExit("port: provide --checkpoint (torch file) and --out")
    if args.model == "hybrid" and not args.temporal_checkpoint:
        raise SystemExit("port hybrid: also provide --temporal-checkpoint")
    sd = torch_port.load_reference_checkpoint(args.checkpoint)
    tsd = (torch_port.load_reference_checkpoint(args.temporal_checkpoint)
           if args.model == "hybrid" else None)
    model, variables = torch_port.import_reference(args.model, sd, tsd)
    path = ckpt.save_state(args.out, 0, model)
    n_arrays = sum(1 for _ in convert._leaves(variables))
    print(f"ported {args.model}: {n_arrays} arrays -> {path}")


def cmd_segment(args) -> None:
    """FCT segmentation training (``SegmentationFlow``): dice loss by
    default, the best-train-loss checkpoint each epoch it improves."""
    from tchvp_tpu_torch.config import TrainConfig
    from tchvp_tpu_torch.train.loops import SegmentationFlow

    attn = _fct_attn(args)
    mesh = _mesh(args)
    cfg = TrainConfig(
        model_name="FCT",
        loss=args.loss or "dice",
        lr=args.lr,
        checkpoint_dir=args.checkpoint_dir,
        **_train_cfg_kwargs(args),
    )
    train, _, test = _image_data(args)
    device = _device(args)
    sp_axis = "spatial" if mesh is not None and "spatial" in mesh.mesh_dim_names else None
    flow = SegmentationFlow(_fct_model(device, attn, sp_axis), cfg=cfg, image_size=args.image_size, mesh=mesh,
                            sp_axis=sp_axis)
    _record_run(args)
    flow.train(train, test, epochs=args.epochs, lr=args.lr)


def _video_model(args, device):
    """--model "hybrid": the flagship CNN+transformer on ``device``; "ae32k"
    (the frame AE of the recovered AE_256_32K workload) or "ae4k" (the 64px
    flat-latent AE_64_4k), each wrapped per frame by ``FrameAE`` so it
    takes (B, T, H, W, C) clips like the hybrid. Weights from a seeded
    generator (seed 0, the JAX package's PRNGKey(0))."""
    import torch

    from tchvp_tpu_torch.config import flagship_video_config
    from tchvp_tpu_torch.models.video import VideoHybridNet

    if args.model != "hybrid":
        if getattr(args, "num_experts", 0):
            raise SystemExit("--num-experts applies to --model hybrid only "
                             "(the temporal transformer's FFNs)")
        if getattr(args, "seq_axis", None):
            raise SystemExit(f"--mesh seq=N applies to --model hybrid only (got --model {args.model})")
        from tchvp_tpu_torch.config import ResNetAEConfig
        from tchvp_tpu_torch.models.frame_ae import FrameAE
        from tchvp_tpu_torch.models.resnet_ae import Autoencoder4K, Autoencoder32K

        tp_axis, sp_axis = getattr(args, "tp_axis", None), getattr(args, "sp_axis", None)
        if args.model == "ae32k":
            return FrameAE(_seeded(Autoencoder32K, ResNetAEConfig(tp_axis=tp_axis, sp_axis=sp_axis),
                                   device=device))
        return FrameAE(_seeded(Autoencoder4K, tp_axis=tp_axis, sp_axis=sp_axis, device=device))
    attn = getattr(args, "attn_impl", None) or "xla"
    if attn == "ring" and not getattr(args, "seq_axis", None):
        raise SystemExit("--attn-impl ring is full attention over seq-sharded tokens: "
                         "run it with --mesh seq=N")
    return VideoHybridNet(_hybrid_config(args, args.image_size, attn),
                          device=device, generator=torch.Generator().manual_seed(0))


def _hybrid_config(args, size: int, attn: str = "xla"):
    """The flagship's config from the flags: ``--layers``, ``--num-experts``,
    ``--router-top-k``, ``--window`` and the mesh axes in use."""
    from tchvp_tpu_torch.config import flagship_video_config

    return flagship_video_config(
        size,
        num_layers=getattr(args, "layers", 2),
        attn_impl=attn,
        window_size=getattr(args, "window", 0),
        num_experts=getattr(args, "num_experts", 0),
        router_top_k=getattr(args, "router_top_k", 1),
        ep_axis=getattr(args, "ep_axis", None),
        seq_axis=getattr(args, "seq_axis", None),
        tp_axis=getattr(args, "tp_axis", None),
        sp_axis=getattr(args, "sp_axis", None),
    )


def cmd_video(args) -> None:
    from tchvp_tpu_torch.config import TrainConfig
    from tchvp_tpu_torch.train.loops import VideoFlow

    if args.synthetic:
        from tchvp_tpu_torch.data.synthetic import SyntheticClips

        data = SyntheticClips(
            args.batch_size, args.clip_len, args.image_size, args.synthetic
        )
    elif args.clippack:
        from tchvp_tpu_torch.data.clippack import ClipPackDataset

        data = ClipPackDataset(args.clippack, args.batch_size)
    else:
        if not args.train_csv:
            raise SystemExit(
                "video: provide --train-csv (a clip manifest), --clippack, "
                "or --synthetic N"
            )
        from tchvp_tpu_torch.data.manifest import ClipDataset

        data = ClipDataset(
            args.train_csv, args.batch_size, args.image_size, args.clip_len,
            prefetch=True,
        )
    if args.num_experts and args.model != "hybrid":
        raise SystemExit("--num-experts applies to --model hybrid only "
                         "(the temporal transformer's FFNs)")
    cfg = TrainConfig(
        model_name="video",
        loss=args.loss or ("mse" if args.image_size <= 160 else "mixed"),
        lr=args.lr,
        checkpoint_dir=args.checkpoint_dir,
        moe_aux_weight=args.moe_aux_weight if args.num_experts else 0.0,
        **_train_cfg_kwargs(args),
    )
    device = _device(args)
    mesh = _mesh(args)  # refuses what JAX's cmd_video refuses (mesh_refusal)
    names = mesh.mesh_dim_names if mesh is not None else ()
    args.seq_axis = "seq" if "seq" in names else None
    args.ep_axis = "expert" if "expert" in names else None
    # "model": tensor parallelism of the transformer's heads and FFN hidden
    # dim and of every conv stack's channels (parallel/tp.py); "spatial":
    # the conv stacks' rows in blocks, halos exchanged (parallel/spatial.py).
    args.tp_axis = "model" if "model" in names else None
    args.sp_axis = "spatial" if "spatial" in names else None
    if args.clippack and "data" in names:
        from tchvp_tpu_torch.parallel.input import sharded_clippack_loader

        # each rank reads its slice: its share of every microbatch
        data = sharded_clippack_loader(args.clippack, args.batch_size, mesh, microbatches=args.accum_steps)
    model = _video_model(args, device)
    flow = VideoFlow(
        model, cfg=cfg, image_size=args.image_size, mesh=mesh,
        fsdp_axis="data" if args.fsdp else None,
        accum_steps=args.accum_steps,
        remat_policy=args.remat_policy,
        qat=args.qat, qat_dense=args.qat_dense,
        seq_axis=args.seq_axis,
        sp_axis=args.sp_axis,
        pipe_axis="pipe" if "pipe" in names else None,
        ep_axis=args.ep_axis,
        aug=_aug_cfg(args),
    )
    start = flow.resume(args.clip_len, data=data) if args.resume else 0
    _record_run(args)
    flow.train(
        data,
        epochs=args.epochs,
        clip_len=args.clip_len,
        start_epoch=start,
        save_every=args.save_every,
        save_every_steps=args.save_every_steps,
    )


def _serving_model(args, size: int, device):
    """The bf16 model of the serving commands (the JAX package's
    ``VideoHybridNet(dtype=bfloat16)``; "xla" attention), or with ``--model
    ae32k|ae4k`` the frame AE cast to bf16, with the checkpoint's weights
    (fp32 on disk, cast on load) when one is given."""
    import torch

    from tchvp_tpu_torch.models.video import VideoHybridNet
    from tchvp_tpu_torch.train import checkpoint as ckpt

    if args.model != "hybrid":
        model = _video_model(args, device).to(torch.bfloat16)
    else:
        model = VideoHybridNet(_hybrid_config(args, size), device=device, dtype=torch.bfloat16,
                               generator=torch.Generator().manual_seed(0))
    if args.checkpoint:
        restored = ckpt.restore_state(args.checkpoint)
        model.load_state_dict(_restored_params(restored, args.ema, args.layers, args.num_experts))
    return model.eval()


def _clip_data(args, size):
    """Shared clip-source selection for the inference commands."""
    if args.clippack:
        from tchvp_tpu_torch.data.clippack import ClipPackDataset

        return ClipPackDataset(args.clippack, args.batch_size, shuffle=False)
    if args.train_csv:
        from tchvp_tpu_torch.data.manifest import ClipDataset

        return ClipDataset(
            args.train_csv, args.batch_size, size, args.clip_len or None,
            shuffle=False, prefetch=True,
        )
    from tchvp_tpu_torch.data.synthetic import SyntheticClips

    return SyntheticClips(
        args.batch_size, args.clip_len, size, max(args.synthetic or 2, 1)
    )


def _reach(url: str, call):
    """``call()`` against a server at ``url``, which exits with a message
    when the server cannot be reached."""
    import urllib.error

    try:
        return call()
    except urllib.error.HTTPError as e:
        raise SystemExit(f"--url {url}: HTTP {e.code}: {e.read().decode(errors='replace')}")
    except (urllib.error.URLError, ConnectionError) as e:
        raise SystemExit(f"--url {url}: cannot reach the server ({getattr(e, 'reason', e)})")


def _stream_remote(url: str, data) -> None:
    """Client side of the /stream session protocol: open a session on a
    ``serve``d STREAMING artifact, post each clip chunk by chunk (the
    carry lives on the server), report throughput, close."""
    import json
    import urllib.request

    import numpy as np

    from tchvp_tpu_torch.infer.server import post_npy

    base = url.rstrip("/")
    opened = json.loads(_reach(url, lambda: urllib.request.urlopen(
        urllib.request.Request(f"{base}/stream/open", method="POST")).read()))
    sid, chunk_len = opened["session"], int(opened["chunk_len"])
    size, sb = int(opened["image_size"]), int(opened["batch"])
    print(f"stream session {sid}: chunk {chunk_len}f @ {size}px batch {sb}")
    frames = 0
    t0 = time.monotonic()
    try:
        for clip in data:
            clip = np.asarray(clip, np.uint8)
            if clip.shape[0] != sb or clip.shape[2:4] != (size, size):
                raise SystemExit(
                    f"stream --url: artifact session wants batch {sb} @ "
                    f"{size}x{size}, data is {clip.shape} — re-export "
                    "with matching --stream-batch/--image-size"
                )
            t = clip.shape[1] - clip.shape[1] % chunk_len
            for start in range(0, t, chunk_len):
                out = _reach(url, lambda: post_npy(f"{base}/stream/{sid}", clip[:, start:start + chunk_len]))
                frames += int(out.shape[0] * out.shape[1])
    finally:
        _reach(url, lambda: urllib.request.urlopen(
            urllib.request.Request(f"{base}/stream/{sid}/close", method="POST")))
    dt = time.monotonic() - t0
    print(f"streamed {frames} frames in {dt:.2f}s "
          f"({frames / max(dt, 1e-9):.1f} frames/s incl. HTTP)")


def cmd_stream(args) -> None:
    """Streaming long-video inference: tile -> chunked carry -> untile.

    Processes clips from a clippack (or synthetic frames) through a
    trained or fresh bf16 VideoHybridNet at any resolution; reports
    throughput. ``--int8`` runs its convs (``--int8-dense``: and denses)
    int8, calibrated on the first batch's tiles; ``--url`` streams through
    a ``serve``d streaming artifact instead."""
    import numpy as np
    import torch

    from tchvp_tpu_torch.models.streaming import StreamingConfig, make_streamer

    if args.clippack:
        from tchvp_tpu_torch.data.clippack import ClipPackDataset

        data = ClipPackDataset(args.clippack, args.batch_size, shuffle=False)
        h, w = data.h, data.w
    else:
        rng = np.random.default_rng(0)
        n = max(args.synthetic, 1)
        h, w = args.height, args.width
        data = [
            rng.integers(0, 256, (args.batch_size, args.clip_len, h, w, 3),
                         dtype=np.uint8)
            for _ in range(n)
        ]
    if args.url:
        _stream_remote(args.url, data)
        return
    device = _device(args)
    scfg = StreamingConfig(
        tile=args.tile, chunk_len=args.chunk_len, ctx_frames=args.ctx_frames
    )
    model = _serving_model(args, args.tile, device)
    engine = None
    data_iter = data
    if args.int8:
        import itertools

        from tchvp_tpu_torch.infer.quant import Int8Engine
        from tchvp_tpu_torch.ops import tiling

        # Calibrate on tiles of the first batch, which stays in the loop.
        it = iter(data)
        try:
            first = next(it)
        except StopIteration:
            print("stream --int8: no batches to calibrate on (empty dataset)")
            return
        data_iter = itertools.chain([first], it)
        clip0 = torch.as_tensor(np.asarray(first, dtype=np.uint8)).to(device).float() / 255.0
        padded, _ = tiling.pad_frames(clip0, args.tile)
        tiles, _ = tiling.tile_frames(padded, args.tile)
        calib = tiles[:4, :2].to(next(model.parameters()).dtype)
        engine = Int8Engine(model, quantize_dense=args.int8_dense).calibrate([calib])
        print(f"int8: {len(engine.scales)} layers quantized"
              + (" (convs+dense)" if args.int8_dense else ""))
    # --data-parallel: every rank streams its block of each global batch
    # (the int8 scales above come from the global first batch on every rank).
    streamer = make_streamer(model, scfg, mesh=_mesh(args), int8_engine=engine)

    frames = 0
    t0 = None
    for batch in data_iter:
        clip = torch.as_tensor(np.asarray(batch, dtype=np.uint8)).to(device).float() / 255.0
        out = streamer(clip)
        _ = float(out.reshape(-1)[0])  # sync
        if t0 is None:  # exclude the warm-up batch
            t0 = time.perf_counter()
        else:
            frames += clip.shape[0] * clip.shape[1]
    if frames:
        dt = time.perf_counter() - t0
        print(f"streamed {frames} frames @ {h}x{w}: {frames/dt:.1f} frames/s")
    else:
        print("streamed 1 batch (warm-up only); add more batches to time")


def cmd_infer(args) -> None:
    """Batched clip inference from a trained checkpoint: reconstruct every
    clip, report PSNR + throughput, optionally dump input|output frame
    pairs. ``--microbatch`` runs over-memory batches as sequential groups
    (the BASELINE config-2 spec-batch path). ``--int8`` runs the convs
    (``--int8-dense``: and denses) int8, calibrated on the first batch.
    ``--exported`` serves an ``export`` artifact instead; ``--url`` posts
    the batches to a running ``serve``."""
    import contextlib
    import itertools

    import numpy as np
    import torch

    from tchvp_tpu_torch.data.pipeline import preprocess_clip
    from tchvp_tpu_torch.models.streaming import microbatched_infer
    from tchvp_tpu_torch.utils.imaging import save_side_by_side

    if args.url:
        return _infer_url(args)
    if args.exported:
        return _infer_exported(args)
    size = args.image_size
    device = _device(args)
    # Serving meshes: data= splits the batch, pipe= runs the temporal stack
    # as a GPipe pipeline (parallel/pipeline.py::pipelined_video_infer).
    axes = {k: v for k, v in _parse_mesh_axes(getattr(args, "mesh", None) or "").items() if v > 1}
    pipe = "pipe" in axes
    if pipe and args.microbatch:
        raise SystemExit("infer: --microbatch and --mesh pipe=N don't compose (the pipeline already microbatches)")
    if pipe and args.int8 and args.int8_dense:
        raise SystemExit("infer: --int8-dense and --mesh pipe=N don't compose (the pipelined temporal stack "
                         "bypasses the Dense interceptor); use conv-only --int8, or --mesh data=N for dense "
                         "quantization")
    mesh = _mesh(args)
    data = _clip_data(args, size)
    model = _serving_model(args, size, device)
    engine = None
    data_iter = data
    if args.int8:
        from tchvp_tpu_torch.infer.quant import Int8Engine

        # Calibrate on the first batch, which rejoins the loop (a half-read
        # native clippack iterator would drain on the next pass).
        it = iter(data)
        try:
            first_batch = next(it)
        except StopIteration:
            print("infer --int8: no batches to calibrate on (empty dataset)")
            return
        data_iter = itertools.chain([first_batch], it)
        first = torch.as_tensor(np.asarray(first_batch, dtype=np.uint8)).to(device)
        calib = preprocess_clip(first, size, dtype=torch.bfloat16)
        engine = Int8Engine(model, quantize_dense=args.int8_dense).calibrate([calib])
        print(f"int8: {len(engine.scales)} layers quantized, "
              f"{engine.psnr_vs(calib):.1f} dB vs bf16")

    ranks, group, batch_axis = 1, None, None
    if pipe:
        from tchvp_tpu_torch.parallel.pipeline import PipelinedVideoNet, pipelined_video_infer

        model = PipelinedVideoNet(model, mesh, "pipe")  # this rank's stage of the temporal layers
    if mesh is not None and "data" in mesh.mesh_dim_names:
        # data=N: this rank's block, the PSNR of the global batch's MSE
        from tchvp_tpu_torch.parallel import axis_group, axis_size
        from tchvp_tpu_torch.parallel.collectives import all_reduce_sum

        ranks, group, batch_axis = axis_size(mesh, "data"), axis_group(mesh, "data"), "data"
    frames, psnrs, t0 = 0, [], None
    for bi, batch in enumerate(data_iter):
        raw = torch.as_tensor(np.asarray(batch, dtype=np.uint8)).to(device)
        if group is not None:
            from tchvp_tpu_torch.parallel import shard_batch

            raw = shard_batch(raw, mesh)
        scope = engine.intercepting(engine.qparams) if engine is not None else contextlib.nullcontext()
        with torch.inference_mode(), scope:
            clip = preprocess_clip(raw, size, dtype=torch.bfloat16)
            if args.microbatch:
                recon = microbatched_infer(model, clip, args.microbatch)
            elif pipe:
                recon = pipelined_video_infer(model, clip, mesh=mesh, batch_axis=batch_axis)[1]
            else:
                recon = model(clip)[1]
            mse = torch.mean((clip.float() - recon.float()) ** 2)
            if group is not None:
                mse = all_reduce_sum(mse, group) / ranks
            psnr = -10.0 * torch.log10(torch.clamp(mse, min=1e-12))
        psnrs.append(float(psnr))  # sync
        if t0 is None:
            t0 = time.perf_counter()  # exclude the warm-up batch
        else:
            frames += raw.shape[0] * raw.shape[1] * ranks
        if bi == 0 and args.out_dir and (group is None or mesh.get_rank() == 0):
            inp = preprocess_clip(raw, size).cpu().numpy()
            out = recon.float().cpu().numpy()
            for t in range(min(raw.shape[1], 8)):
                save_side_by_side(
                    [inp[0, t], out[0, t]],
                    os.path.join(args.out_dir, f"clip0_frame{t}.jpg"),
                )
    msg = f"inferred {len(psnrs)} batches, mean PSNR {np.mean(psnrs):.2f} dB"
    if frames and t0 is not None:
        msg += f", {frames / (time.perf_counter() - t0):.1f} frames/s (post-warm-up)"
    print(msg)


def _psnr_db(clip: "torch.Tensor", recon: "torch.Tensor") -> float:
    import torch

    mse = float(torch.mean((clip.float() - recon.float()) ** 2))
    return -10.0 * math.log10(max(mse, 1e-12))


def _infer_exported(args) -> None:
    """Serve an ``export`` artifact: the program, its weights and the
    fused preprocessing all come from the artifact, on its platform."""
    import numpy as np
    import torch

    from tchvp_tpu_torch.data.pipeline import preprocess_clip
    from tchvp_tpu_torch.infer import export as export_lib

    if not os.path.exists(args.exported):
        raise SystemExit(f"--exported {args.exported}: no such artifact")
    device = _device(args)
    m = export_lib.load_artifact(args.exported, device)
    size = int(m.meta["meta"].get("image_size", args.image_size))
    frames, psnrs, t0 = 0, [], None
    for batch in _clip_data(args, size):
        raw = np.asarray(batch, dtype=np.uint8)
        recon = m(raw)
        with torch.inference_mode():
            psnrs.append(_psnr_db(preprocess_clip(torch.from_numpy(raw).to(device), size), recon))
        if t0 is None:
            t0 = time.perf_counter()  # exclude the first call
        else:
            frames += raw.shape[0] * raw.shape[1]
    msg = (f"served {len(psnrs)} batches from {args.exported} "
           f"(platforms {list(m.platforms)}), mean PSNR {np.mean(psnrs):.2f} dB")
    if frames and t0 is not None:
        msg += f", {frames / (time.perf_counter() - t0):.1f} frames/s (post-load)"
    print(msg)


def _infer_url(args) -> None:
    """Client mode: POST every batch to a running ``serve`` (the serving
    host owns the card); this process decodes clips and scores PSNR on the
    CPU."""
    import numpy as np
    import torch

    from tchvp_tpu_torch.data.pipeline import preprocess_clip
    from tchvp_tpu_torch.infer.server import post_npy

    url = args.url.rstrip("/") + "/infer"
    frames, psnrs, t0 = 0, [], None
    for batch in _clip_data(args, args.image_size):
        raw = np.asarray(batch, dtype=np.uint8)
        rec = _reach(args.url, lambda: post_npy(url, raw))
        psnrs.append(_psnr_db(preprocess_clip(torch.from_numpy(raw), args.image_size), torch.from_numpy(rec)))
        if t0 is None:
            t0 = time.perf_counter()  # exclude the first (warm-up) call
        else:
            frames += raw.shape[0] * raw.shape[1]
    if not psnrs:
        print(f"no batches to send to {args.url}")
        return
    msg = f"served {len(psnrs)} batches via {args.url}, mean PSNR {np.mean(psnrs):.2f} dB"
    if frames and t0 is not None:
        msg += f", {frames / (time.perf_counter() - t0):.1f} frames/s (post-warm-up)"
    print(msg)


_EXPORT_IMAGE_MODELS = ("fct", "unet", "ae", "combined")
_EXPORT_CLIP_MODELS = ("hybrid", "ae32k", "ae4k")


def cmd_summary(args) -> None:
    """Per-module parameter table of the model (torchsummary parity),
    built on the CPU without a checkpoint:

        python -m tchvp_tpu_torch.cli summary --model hybrid --depth 2
    """
    import torch

    from tchvp_tpu_torch.utils.summary import describe, summarize

    if args.model in _EXPORT_IMAGE_MODELS:
        model = _image_model(args.model, torch.device("cpu"))
        shape = (1, args.image_size, args.image_size, 3)
    else:
        model = _video_model(args, torch.device("cpu"))
        shape = (1, args.clip_len, args.image_size, args.image_size, 3)
    print(summarize(model, depth=args.depth))
    print(describe(model))
    print(f"Input: {shape} float32")


def cmd_shards(args) -> None:
    """Sharding and memory plan of a training config before a card is
    committed: the placement and per-device bytes of every parameter,
    gradient, optimizer-state and BatchNorm leaf under ``--mesh``, by the
    rules the run-time applies (``parallel/plan.py``). The model is built
    on the ``meta`` device: no device, no weights, no processes:

        python -m tchvp_tpu_torch.cli shards --model hybrid --mesh data=8 --fsdp
        python -m tchvp_tpu_torch.cli shards --mesh data=16,expert=4 --num-experts 8
        python -m tchvp_tpu_torch.cli shards --mesh data=4,pipe=2 --fsdp
    """
    print(_shards_plan(args).table(top=args.top, hbm_gb=args.hbm_gb))


def _shards_plan(args):
    """The ``ShardingPlan`` that ``shards`` prints."""
    import torch

    from tchvp_tpu_torch.parallel.plan import abstract_pipelined_train_state, abstract_train_state, plan_state
    from tchvp_tpu_torch.train.state import make_optimizer

    axes = _parse_mesh_axes(args.mesh) or {"data": 1}
    size = args.image_size
    with torch.device("meta"):
        if args.model in _EXPORT_IMAGE_MODELS:
            model, batch = _image_model(args.model, "meta"), (args.batch_size, size, size, 3)
        else:
            model, batch = _video_model(args, "meta"), (args.batch_size, args.clip_len, size, size, 3)
    tx = make_optimizer(args.lr, ema_decay=args.ema_decay, optimizer=args.optimizer)
    # pipe= plans the pipelined layout: stage parameters and moments over
    # "pipe", the CNN's ("rest") over data with --fsdp.
    pipe_axis = "pipe" if axes.get("pipe", 1) > 1 else None
    if pipe_axis:
        if args.model != "hybrid":
            raise SystemExit("shards: --mesh pipe=N plans --model hybrid "
                             "(the temporal transformer is what pipelines)")
        if args.layers % axes["pipe"]:
            raise SystemExit(f"shards: --layers {args.layers} must be a multiple of pipe={axes['pipe']}")
        state = abstract_pipelined_train_state(model, tx, axes["pipe"])
    else:
        state = abstract_train_state(model, tx)
    return plan_state(
        state, axes,
        fsdp_axis="data" if args.fsdp else None,
        ep_axis="expert" if "expert" in axes else None,
        num_experts=args.num_experts,
        batch_axis="data",
        batch_example={"clip" if len(batch) == 5 else "image": torch.empty(batch, device="meta")},
        pipe_axis=pipe_axis,
    )


def _validate_restored_depth(state_dict, expect_layers: int, expect_experts=None) -> None:
    """Reject a temporal-depth mismatch between a restored checkpoint and
    the ``--layers`` model loudly, with the JAX package's message; with
    ``expect_experts``, an MoE checkpoint against a dense ``--num-experts``
    model (or the reverse, or another expert count) too, which JAX's apply
    refuses through the missing parameters."""
    layers = {int(k.split(".")[2]) for k in state_dict if k.startswith("temporal.layers.")}
    if not layers:
        return  # not a hybrid checkpoint
    depth = 1 + max(layers)
    if depth != expect_layers:
        raise SystemExit(
            f"checkpoint temporal depth is {depth} layers but the model "
            f"was built with --layers {expect_layers}; pass --layers {depth}"
        )
    if expect_experts is None:
        return
    router = state_dict.get("temporal.layers.0.moe.router")
    experts = int(router.shape[1]) if router is not None else 0
    if experts != (expect_experts if expect_experts >= 2 else 0):
        raise SystemExit(
            f"checkpoint temporal FFN has {experts or 'no'} experts but the model was built "
            f"with --num-experts {expect_experts}; pass --num-experts {experts}")


def _restored_params(restored: dict, ema: bool, expect_layers=None, expect_experts=None):
    """The model ``state_dict`` of a ``restore_state`` payload, or with
    ``--ema`` the EMA parameter average the optimizer carried over the
    checkpoint's BatchNorm stats. With ``expect_layers`` the temporal
    depth is checked against the ``--layers`` model, with
    ``expect_experts`` its MoE pool against ``--num-experts``."""
    from tchvp_tpu_torch.train.state import ema_state_dict

    payload = restored["model"]
    if ema:
        e = (restored.get("opt_state") or {}).get("ema")
        if e is None:
            raise SystemExit(
                "--ema: checkpoint carries no EMA state (train with --ema-decay)"
            )
        payload = ema_state_dict(payload, e)
    from tchvp_tpu_torch.parallel import pipeline as ppl

    if ppl.is_pipelined_params(payload):  # a `video --mesh pipe=N` run's layout
        payload = ppl.merge_pipelined_params(payload)
    if expect_layers is not None:
        _validate_restored_depth(payload, expect_layers, expect_experts)
    return payload


def cmd_eval(args) -> None:
    """Standalone checkpoint evaluation over a clip dataset:

        python -m tchvp_tpu_torch.cli eval --model hybrid --checkpoint ckpts/step_40

    Accepts both checkpoint formats: step-tagged full states
    (``save_state``) and weights-only checkpoints (``save_params``). Only
    the model's parameters and BatchNorm stats load, not the optimizer
    state, whose shape depends on the training run's flags."""
    from tchvp_tpu_torch.config import TrainConfig
    from tchvp_tpu_torch.train import checkpoint as ckpt
    from tchvp_tpu_torch.train.loops import DenoisingFlow, SegmentationFlow, VideoFlow

    if getattr(args, "test_csv", None) and not args.train_csv:
        args.train_csv = args.test_csv
    if args.int8 and args.model not in _EXPORT_CLIP_MODELS:
        raise SystemExit("eval --int8 supports the video models (hybrid/ae32k/ae4k)")
    path = args.checkpoint or ckpt.latest_step_dir(args.checkpoint_dir)
    src = f"ckpt {path}" if path else "fresh params (no checkpoint found)"
    device = _device(args)

    def load(model):
        if path:
            raw = ckpt.restore_state(path)
            if "step" not in raw and args.ema:
                raise SystemExit("--ema needs a full-state checkpoint, got weights-only")
            model.load_state_dict(_restored_params(raw, args.ema, args.layers,
                                                   getattr(args, "num_experts", None)))

    if args.model == "fct":
        loss = args.loss or "dice"
        flow = SegmentationFlow(
            _fct_model(device),
            cfg=TrainConfig(model_name="FCT", loss=loss, checkpoint_dir=args.checkpoint_dir),
            image_size=args.image_size,
        )
        flow.init_state()
        load(flow.model)
        m = flow.evaluate(_image_data(args)[0])
        print(f"eval fct: {loss} loss {m['loss']:.4f}, IoU {m['iou']:.3f}  [{src}]")
        return
    if args.model == "ae":
        flow = DenoisingFlow(_image_model("ae", device),
                             cfg=TrainConfig(checkpoint_dir=args.checkpoint_dir),
                             image_size=args.image_size)
        flow.init_state()
        load(flow.model)
        psnr = flow.validate(_image_data(args, supervised=False)[0])
        print(f"eval ae: reconstruction PSNR {psnr:.2f} dB  [{src}]")
        return
    if args.model in ("unet", "combined"):
        model = _image_model(args.model, device)
        load(model)
        sums, n = _eval_masks(model.eval(), args.model == "combined", args.image_size,
                              _image_data(args)[0], device)
        parts = ", ".join(f"{k} {sums[k] / max(n, 1):.4f}" for k in sorted(sums))
        print(f"eval {args.model}: {parts} over {n} batches  [{src}]")
        return
    flow = VideoFlow(
        _video_model(args, device),
        cfg=TrainConfig(model_name="video", loss="mse", checkpoint_dir=args.checkpoint_dir),
        image_size=args.image_size, mesh=_mesh(args),
    )
    flow.init_state(args.clip_len)
    load(flow.model)
    if args.int8:
        psnr = _int8_eval(flow.model, args, device)
        print(f"eval {args.model} [int8 serving]: reconstruction PSNR {psnr:.2f} dB  [{src}]")
        return
    psnr = flow.evaluate(_clip_data(args, args.image_size))
    print(f"eval {args.model}: reconstruction PSNR {psnr:.2f} dB  [{src}]")


def _int8_eval(model, args, device) -> float:
    """Serving-mode eval: the mean PSNR of the int8 engine's output
    against the clean clips, calibrated on the first batch (what ``infer
    --int8`` ships, and the yardstick of a ``--qat`` checkpoint)."""
    import numpy as np
    import torch

    from tchvp_tpu_torch import losses
    from tchvp_tpu_torch.data.pipeline import preprocess_clip
    from tchvp_tpu_torch.infer.quant import Int8Engine

    size = args.image_size
    data = _clip_data(args, size)
    clean_of = lambda b: preprocess_clip(torch.as_tensor(np.asarray(b)).to(device), size)  # noqa: E731
    try:
        first = next(iter(data))
    except StopIteration:
        raise SystemExit("eval --int8: no batches to calibrate on")
    eng = Int8Engine(model, quantize_dense=args.int8_dense).calibrate([clean_of(first)])
    vals = []
    for b in data:
        clean = clean_of(b)
        vals.append(float(losses.psnr(eng.apply(eng.qparams, clean)[1], clean)))
    return sum(vals) / len(vals)


def _eval_masks(model, combined: bool, size: int, data, device):
    """Per-batch sums of dice loss and IoU (and, for the combined model,
    the reconstruction's PSNR) of an eval-mode mask model over (image, mask)
    batches; returns (sums, batches)."""
    import numpy as np
    import torch

    from tchvp_tpu_torch import losses
    from tchvp_tpu_torch.data import pipeline

    sums, n = {}, 0
    for image_u8, mask_u8 in data:
        x, y = (pipeline.preprocess_images(torch.as_tensor(np.asarray(t)).to(device), size)
                for t in (image_u8, mask_u8))
        with torch.no_grad():
            out = model(x)
        m = {}
        if combined:
            _, recon, mask = out
            m["psnr"] = losses.psnr(recon, x)
        else:
            mask = out
        m["dice"] = losses.dice_loss(mask, y)
        m["iou"] = losses.jaccard_score(mask > 0.5, y > 0.5)
        for k, v in m.items():
            sums[k] = sums.get(k, 0.0) + float(v)
        n += 1
    return sums, n


def cmd_pack(args) -> None:
    """Offline: decode a clip CSV manifest into a clippack file once, so
    training epochs stream from the native loader."""
    from tchvp_tpu_torch.data.clippack import pack_from_manifest

    if not args.train_csv or not args.out:
        raise SystemExit("pack: provide --train-csv and --out")
    n, t = pack_from_manifest(
        args.train_csv, args.out, args.image_size, args.clip_len or None
    )
    print(f"packed {n} clips x {t} frames -> {args.out}")


def _smi(fields: str) -> str:
    """``nvidia-smi --query-gpu=<fields>`` of the first card, or why not."""
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() \
        else f"nvidia-smi failed (exit {out.returncode})"


def _print_autotune_cache() -> None:
    """``doctor``'s line on the autotune cache (JAX's words)."""
    import json

    from tchvp_tpu_torch.kernels import autotune

    at = autotune.cache_path()
    if at and os.path.exists(at):
        with open(at) as f:
            n_tuned = len(json.load(f))
        print(f"autotune cache: {at} ({n_tuned} tuned entries)")
    else:
        print(f"autotune cache: {at or 'disabled'} (empty — run `tune` on the target device)")


def cmd_doctor(args) -> None:
    """Environment / runtime diagnostics: torch and CUDA, the cards, their
    power limit and memory, the builds of the kernel libraries and of the
    native clippack loader. ``--smoke`` also runs one flash-attention
    forward against its plain version. Exits 1 without a CUDA device."""
    import torch
    import torch.distributed as dist

    rank, world = (dist.get_rank(), dist.get_world_size()) if dist.is_initialized() else (0, 1)
    print(f"torch {torch.__version__}  cuda {torch.version.cuda}  process {rank}/{world}")
    cuda = torch.cuda.is_available()
    if cuda:
        for i in range(torch.cuda.device_count()):
            free, total = torch.cuda.mem_get_info(i)
            print(f"device {i}: {torch.cuda.get_device_name(i)}, memory "
                  f"{(total - free) / 2**30:.2f} / {total / 2**30:.2f} GiB in use")
        print(f"nvidia-smi (name, power limit): {_smi('name,power.limit')}")
    else:
        print("devices: no CUDA device")

    from tchvp_tpu_torch.data import clippack
    from tchvp_tpu_torch.kernels import build

    try:
        clippack.load_native()
        print(f"native clippack loader: OK (g++, {build.build_seconds['clippack']:.2f} s)")
    except RuntimeError as e:
        print(f"native clippack loader: unavailable ({e}); the numpy reader is "
              "used only when asked (prefer_native=False)")
    if not cuda:
        raise SystemExit("doctor: no CUDA device; the kernel libraries build and "
                         "run only on a card")
    t0 = time.perf_counter()
    libs = build.load_all(build.LIBRARIES)
    print(f"kernel libraries: {', '.join(sorted(libs))} built or cached in "
          f"{time.perf_counter() - t0:.2f} s (nvcc {build.nvcc_path()})")
    _print_autotune_cache()

    if args.smoke:
        import numpy as np

        from tchvp_tpu_torch.kernels import flash_attention as fa

        rng = np.random.default_rng(0)
        b, h, s, dh = 2, 8, 128, 64
        q, k, v = (torch.from_numpy(rng.standard_normal((b, h, s, dh), dtype=np.float32))
                   .to("cuda", torch.bfloat16) for _ in range(3))
        t0 = time.perf_counter()
        out = fa.mha(q, k, v)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        ref = fa.mha_reference(*(t.reshape(b * h, s, dh).float() for t in (q, k, v)),
                               scale=dh ** -0.5)[0].reshape(b, h, s, dh)
        err = (out.float() - ref).abs().max().item()
        limit = 1e-2 * ref.abs().max().item()
        print(f"smoke flash forward {(b, h, s, dh)} bf16: max abs {err:.3g} against the "
              f"plain version (limit {limit:.3g}), first call {ms:.1f} ms")
        if not err <= limit:
            raise SystemExit("doctor --smoke: the flash forward disagrees with its plain version")


def cmd_tune(args) -> None:
    """Autotune the Hopper attention kernels' blocks on this card and
    persist the winners (``kernels/autotune.py``); later processes launch
    the tuned blocks. It times the card, so it exits without one."""
    import torch

    from tchvp_tpu_torch.kernels import autotune

    shape = tuple(int(x) for x in args.shape.split("x"))
    if len(shape) != 4:
        raise SystemExit("tune: --shape must be BxHxSxDh, e.g. 8x8x2048x64")
    kinds = args.kernels.split(",") if args.kernels else ["flash", "band"]
    path = autotune.cache_path()
    if path is None:
        raise SystemExit("tune: TCHVP_AUTOTUNE_CACHE=0 disables the cache")
    if not torch.cuda.is_available():
        raise SystemExit("tune: no CUDA device; tune times the kernels on the card")
    for kind in kinds:
        print(f"tuning {kind} @ {shape} dtype={args.dtype} "
              f"window={args.window} mode={args.mode}", flush=True)
        if kind == "flash":
            params, ms = autotune.tune_flash(shape, args.dtype, mode=args.mode, iters=args.iters)
        elif kind in ("band", "halo"):
            if not args.window:
                raise SystemExit(f"tune: {kind} needs --window")
            params, ms = autotune.tune_banded(shape, args.window, args.dtype, halo=(kind == "halo"),
                                              mode=args.mode, iters=args.iters)
        else:
            raise SystemExit(f"tune: unknown kernel {kind!r} (flash, band, halo)")
        print(f"  -> best {params} at {ms:.3f} ms (saved to {path})")


def _export_model(args, device):
    """The model of ``export --model`` on ``device``, seeded weights (fp32,
    eval mode): (model, is_clip)."""
    if args.model in _EXPORT_CLIP_MODELS:
        return _video_model(args, device).eval(), True
    return _image_model(args.model, device).eval(), False


def cmd_export(args) -> None:
    """AOT-export a serving program (uint8 batch -> output, preprocessing
    fused in) to a .tchvp artifact through ``torch.export``
    (``infer/export.py``): the serving host loads program and weights, no
    model code. Clip models serve (B, T, H, W, 3) clips, image models (fct,
    unet, ae, combined) (B, H, W, 3) images. The program is exported on
    ``--device`` and serves there only."""
    import numpy as np
    import torch

    from tchvp_tpu_torch.data.pipeline import preprocess_clip
    from tchvp_tpu_torch.infer import export as export_lib
    from tchvp_tpu_torch.train import checkpoint as ckpt

    if not args.out:
        raise SystemExit("export: provide --out (artifact path)")
    size = args.image_size
    device = _device(args)
    platforms = ([p.strip() for p in args.platforms.split(",") if p.strip()]
                 if args.platforms else None)
    if platforms is not None and platforms != [device.type]:
        raise SystemExit(f"export --platforms {args.platforms}: a program serves on the platform it is "
                         f"exported on; pass --device for it ({device.type} here)")
    model, is_clip = _export_model(args, device)
    if args.checkpoint:
        restored = ckpt.restore_state(args.checkpoint)
        model.load_state_dict(_restored_params(restored, args.ema, args.layers, args.num_experts))
    engine = None
    if args.int8:
        from tchvp_tpu_torch.infer.quant import Int8Engine

        if not is_clip:
            raise SystemExit(
                "export --int8 currently supports the clip models "
                f"({', '.join(_EXPORT_CLIP_MODELS)}); use the fp export or "
                "`infer --int8` for the image models")
        try:
            first = next(iter(_clip_data(args, size)))
        except StopIteration:
            raise SystemExit("export --int8: no batches to calibrate on")
        calib = preprocess_clip(torch.as_tensor(np.asarray(first, dtype=np.uint8)).to(device), size,
                                dtype=next(model.parameters()).dtype)
        engine = Int8Engine(model, quantize_dense=args.int8_dense).calibrate([calib])
        print(f"int8: {len(engine.scales)} layers quantized, "
              f"{engine.psnr_vs(calib):.1f} dB vs {str(calib.dtype).removeprefix('torch.')}")
    if args.streaming:
        if args.model != "hybrid":
            raise SystemExit("export --streaming applies to --model hybrid")
        geometry = dict(chunk_len=args.chunk_len, ctx_frames=args.ctx_frames, image_size=size,
                        batch=args.stream_batch)
        if engine is not None:
            exported, record = export_lib.export_int8_streaming_step(engine, platforms=platforms, **geometry)
        else:
            exported, record = export_lib.export_streaming_step(model, platforms=platforms, **geometry)
        export_lib.save_artifact(args.out, exported, record, meta={
            "model": args.model, "checkpoint": args.checkpoint or "", "int8": bool(args.int8),
            **export_lib.streaming_meta(tokens_per_frame=model.config.tokens_per_frame, **geometry)})
        print(f"exported STREAMING{' int8' if args.int8 else ''} {args.model} {size}px "
              f"chunk {args.chunk_len}f ctx {args.ctx_frames}f -> {args.out} "
              f"({os.path.getsize(args.out) / 1e6:.1f} MB, platforms {record['platforms']}) — "
              f"serve it and POST chunks to /stream/<session>")
        return
    symbolic = not args.static_batch
    if engine is not None:
        exported, record = export_lib.export_int8_video_model(
            engine, clip_len=args.clip_len, image_size=size, platforms=platforms, symbolic_batch=symbolic)
    elif is_clip:
        exported, record = export_lib.export_video_model(
            model, clip_len=args.clip_len, image_size=size, platforms=platforms, symbolic_batch=symbolic)
    else:
        exported, record = export_lib.export_image_model(
            model, image_size=size, platforms=platforms, symbolic_batch=symbolic)
    export_lib.save_artifact(args.out, exported, record, meta={
        "model": args.model, "image_size": size, "clip_len": args.clip_len if is_clip else 0,
        "checkpoint": args.checkpoint or "", "int8": bool(args.int8)})
    shape = f"{size}px x {args.clip_len}f" if is_clip else f"{size}px"
    print(f"exported {args.model} {shape} -> {args.out} "
          f"({os.path.getsize(args.out) / 1e6:.1f} MB, platforms {record['platforms']}, "
          f"batch {'symbolic' if symbolic else 'static'})")


def _serve_live_pipelined(args, axes: dict, buckets) -> None:
    """``serve --mesh data=K,pipe=N``: the flagship served live with its
    temporal stack as a GPipe pipeline over the ranks; rank 0 serves HTTP,
    the others follow its batches until it stops. The weights come from
    ``--checkpoint``, which is required."""
    from tchvp_tpu_torch.infer.server import serve_live_pipelined

    if args.exported:
        raise SystemExit("serve: --exported and --mesh pipe=N don't compose (artifacts can't carry the "
                         "pipeline's schedule over processes) — live serving builds the model from "
                         "--checkpoint")
    others = [a for a in axes if a not in ("data", "pipe")]
    if others:
        raise SystemExit(f"serve: --mesh pipe=N composes with data= only (got {others})")
    if getattr(args, "model", "hybrid") != "hybrid":
        raise SystemExit("serve: --mesh pipe=N serves --model hybrid (the temporal transformer is what pipelines)")
    if args.layers % axes["pipe"]:
        raise SystemExit(f"serve: --layers {args.layers} must be a multiple of pipe={axes['pipe']}")
    if not args.checkpoint:
        raise SystemExit("serve: --mesh pipe=N serves the weights of --checkpoint (a step_* dir); "
                         "give one, there are no weights to serve without it")
    mesh = _mesh(args)
    size = args.image_size
    model = _serving_model(args, size, _device(args))
    print(f"warming buckets {list(buckets) if buckets else '(default)'} through the pipeline...", flush=True)
    srv = serve_live_pipelined(model, mesh, axis="pipe", batch_axis="data" if "data" in axes else None,
                               image_size=size, clip_len=args.clip_len, host=args.host, port=args.port,
                               buckets=buckets, batch_window_ms=args.batch_window_ms)
    if srv is None:  # a following rank: rank 0 has stopped
        return
    host, port = srv.address
    print(f"serving LIVE pipelined hybrid on http://{host}:{port} (mesh {axes}, buckets "
          f"{list(srv.buckets)}) — POST /infer, GET /health", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.shutdown()
        srv.model.stop()


def cmd_serve(args) -> None:
    """HTTP serving daemon (``infer/server.py``) of an ``export``
    artifact: POST .npy batches to /infer, GET /health; /stream sessions
    for a streaming artifact. ``--data-parallel`` serves one replica a
    visible card, each request batch split over them; ``--mesh
    data=K,pipe=N`` serves the flagship live from ``--checkpoint``, its
    temporal stack as a pipeline over the ranks."""
    from tchvp_tpu_torch.infer.server import serve_artifact

    axes = {k: v for k, v in _parse_mesh_axes(args.mesh or "").items() if v > 1}
    buckets = (tuple(int(b) for b in args.buckets.split(",")) if args.buckets else None)
    if axes.get("pipe", 1) > 1:
        return _serve_live_pipelined(args, axes, buckets)
    if axes:
        raise SystemExit("serve: --mesh supports data=K,pipe=N (live pipelined serving); use "
                         "--data-parallel for artifact dp serving")
    if not args.exported:
        raise SystemExit("serve: provide --exported (a .tchvp artifact) or --mesh data=K,pipe=N with "
                         "--checkpoint (live pipelined serving)")
    if not os.path.exists(args.exported):
        raise SystemExit(f"serve --exported {args.exported}: no such artifact")
    print(f"warming buckets {list(buckets) if buckets else '(off)'}...", flush=True)
    srv = serve_artifact(args.exported, args.host, args.port, buckets=buckets,
                         batch_window_ms=args.batch_window_ms, device=_device(args),
                         data_parallel=args.data_parallel)
    host, port = srv.address
    print(f"serving {args.exported} on http://{host}:{port} "
          f"(platforms {list(srv.model.platforms)}, "
          f"buckets {list(srv.buckets) if srv.buckets else 'off'}) — POST /infer, GET /health",
          flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        srv.shutdown()


def _build_parser():
    from tchvp_tpu_torch.parallel.plan import CARD_MEMORY_GIB

    parser = argparse.ArgumentParser("tchvp_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    subparsers = {}
    commands = {"video": cmd_video, "segment": cmd_segment, "denoise": cmd_denoise,
                "transfer": cmd_transfer, "port": cmd_port, "pack": cmd_pack,
                "stream": cmd_stream, "infer": cmd_infer, "eval": cmd_eval, "summary": cmd_summary,
                "export": cmd_export, "serve": cmd_serve, "shards": cmd_shards}

    for name in commands:
        p = sub.add_parser(name)
        subparsers[name] = p
        _add_common(p)
        p.set_defaults(fn=commands[name])
        if name == "video":
            p.add_argument("--clip-len", type=int, default=8)
            p.add_argument("--clippack", default=None)
            p.add_argument("--resume", action="store_true")
            p.add_argument("--save-every", type=int, default=10)
            p.add_argument("--save-every-steps", type=int, default=0,
                           help="also checkpoint every N batches WITHIN "
                                "an epoch, recording the dataset position "
                                "so --resume seeks mid-epoch (preemption "
                                "tolerance; clippack datasets)")
            p.add_argument("--model", default="hybrid",
                           choices=("hybrid", "ae32k", "ae4k"))
            p.add_argument("--mesh", default=None,
                           help="device mesh as axis=size pairs; the port runs "
                                "data=N (data parallelism; --fsdp shards the "
                                "state over it), seq=N (sequence parallelism: "
                                "--window, or --attn-impl ring), expert=N "
                                "(expert parallelism, with --num-experts), "
                                "model=N (tensor parallelism: heads, FFN hidden "
                                "dim and conv channels), spatial=N (the conv "
                                "stacks' rows in blocks, halos exchanged) and "
                                "pipe=N (the temporal layers as a GPipe "
                                "pipeline); any product of seq, model, expert "
                                "and spatial, with or without data=N, and "
                                "pipe=N beside data=N alone, as JAX's video; "
                                "one process per rank")
            p.add_argument("--layers", type=int, default=2,
                           help="temporal transformer depth (hybrid model)")
            p.add_argument("--attn-impl", default="xla",
                           choices=("xla", "flash", "windowed", "auto", "ring"),
                           help="temporal-attention core (hybrid model); "
                                "flash = the hand-written kernels")
            p.add_argument("--window", type=int, default=0,
                           help="attention window (tokens); 0 = full. "
                                "--mesh seq=N needs it or --attn-impl ring")
            p.add_argument("--num-experts", type=int, default=0,
                           help="routed MoE temporal FFN with N experts "
                                "(ops/moe.py); 0 = the dense FFNs")
            p.add_argument("--moe-aux-weight", type=float, default=0.01,
                           help="Switch load-balance loss weight (only with "
                                "--num-experts)")
            p.add_argument("--router-top-k", type=int, default=1,
                           help="experts per token (1 = Switch, 2 = GShard "
                                "top-2); training logs moe_drop_frac")
            p.add_argument("--fsdp", action="store_true",
                           help="ZeRO-3: parameters, optimizer moments and EMA "
                                "sharded over the data axis (parallel/fsdp.py), "
                                "checkpoints shard-wise; needs --mesh data=N or "
                                "--data-parallel")
            p.add_argument("--accum-steps", type=int, default=1,
                           help="gradient accumulation: split each batch "
                                "into N microbatches, one optimizer update")
            p.add_argument("--qat", action="store_true",
                           help="quantization-aware training: convs run on "
                                "fake-int8 input and kernel with STE gradients "
                                "(train/qat.py), so the checkpoint serves "
                                "through the int8 engine")
            p.add_argument("--qat-dense", action="store_true",
                           help="with --qat: fake-quantize the Dense layers too")
            p.add_argument("--remat-policy", default="none",
                           choices=("none", "full", "stages", "dots"),
                           help="rematerialization policy for the train "
                                "step (torch.utils.checkpoint)")
        if name == "segment":
            p.add_argument("--mesh", default=None,
                           help="axis=size pairs: data=N and spatial=N (FCT's "
                                "rows in blocks, halos exchanged), one process "
                                "per rank")
            p.add_argument("--attn-impl", default=None,
                           choices=("auto", "xla", "flash", "ring"),
                           help="FCT spatial-attention core (default auto: the "
                                "flash kernels on a card); ring rides the "
                                "spatial axis")
        if name == "transfer":
            p.add_argument("--pretrained", default=None)
        if name == "port":
            p.add_argument("--checkpoint", default=None,
                           help="reference torch .tar/.pth file")
            p.add_argument("--temporal-checkpoint", default=None)
            p.add_argument("--out", default=None)
            p.add_argument("--model", default="ae32k",
                           choices=("unet", "fct", "autoencoder", "ae32k",
                                    "ae4k", "transformer", "hybrid"))
        if name == "pack":
            p.add_argument("--out", default=None)
            p.add_argument("--clip-len", type=int, default=0)
        if name in ("infer", "stream"):
            p.add_argument("--model", default="hybrid", choices=_EXPORT_CLIP_MODELS,
                           help="the flagship, or a frame AE (ae32k, ae4k) run per frame")
        if name == "infer":
            p.add_argument("--clippack", default=None)
            p.add_argument("--checkpoint", default=None)
            p.add_argument("--mesh", default=None,
                           help="data=N: each of N ranks infers its block of every batch; "
                                "pipe=N: the temporal stack as a GPipe pipeline over N ranks "
                                "(a stage each); data=N,pipe=M both, one process a rank")
            p.add_argument("--ema", action="store_true",
                           help="serve the EMA parameter average the "
                                "optimizer carried (--ema-decay training) "
                                "instead of the live params")
            _add_checkpoint_model_flags(p)
            p.add_argument("--exported", default=None,
                           help="serve a .tchvp artifact (export) instead of the model")
            p.add_argument("--url", default=None,
                           help="POST the batches to a running serve endpoint")
            p.add_argument("--clip-len", type=int, default=8)
            p.add_argument("--microbatch", type=int, default=0)
            p.add_argument("--out-dir", default=None)
            p.add_argument("--int8", action="store_true",
                           help="int8 post-training quantization of the convs, "
                                "calibrated on the first batch (infer/quant.py)")
            p.add_argument("--int8-dense", action="store_true",
                           help="with --int8: also quantize the Dense layers")
        if name == "eval":
            p.add_argument("--model", default="hybrid",
                           choices=("hybrid", "ae32k", "ae4k", "fct", "ae",
                                    "unet", "combined"))
            p.add_argument("--checkpoint", default=None,
                           help="step_* dir (save_state) or weights-only "
                                "dir (save_params); default: newest step "
                                "dir under --checkpoint-dir")
            _add_checkpoint_model_flags(p)
            p.add_argument("--ema", action="store_true",
                           help="evaluate the EMA parameter average the "
                                "optimizer carried (--ema-decay training)")
            p.add_argument("--int8", action="store_true",
                           help="int8 post-training quantization of the convs, "
                                "calibrated on the first batch (infer/quant.py)")
            p.add_argument("--int8-dense", action="store_true",
                           help="with --int8: also quantize the Dense layers")
            p.add_argument("--clippack", default=None)
            p.add_argument("--clip-len", type=int, default=8)
        if name == "summary":
            p.add_argument("--model", default="hybrid",
                           choices=_EXPORT_CLIP_MODELS + _EXPORT_IMAGE_MODELS)
            p.add_argument("--clip-len", type=int, default=8)
            _add_checkpoint_model_flags(p)
            p.add_argument("--depth", type=int, default=None,
                           help="module nesting depth to show "
                                "(default: all submodules)")
        if name == "shards":
            p.add_argument("--model", default="hybrid",
                           choices=_EXPORT_CLIP_MODELS + _EXPORT_IMAGE_MODELS)
            p.add_argument("--clip-len", type=int, default=8)
            _add_checkpoint_model_flags(p)
            p.add_argument("--mesh", default="data=1",
                           help="axis=size pairs, e.g. data=16,expert=4 "
                                "— no devices needed, planning is abstract")
            p.add_argument("--fsdp", action="store_true",
                           help="plan ZeRO-3 placement over the data axis "
                                "(parallel/fsdp.py rules)")
            p.add_argument("--hbm-gb", type=float, default=CARD_MEMORY_GIB,
                           help="per-device memory budget in GiB for the %% line "
                                "(default: an NVIDIA H100 80GB HBM3's total_memory, "
                                "power limit 700 W)")
            p.add_argument("--top", type=int, default=12,
                           help="largest-N leaf rows to print")
        if name == "stream":
            p.add_argument("--clippack", default=None)
            p.add_argument("--checkpoint", default=None)
            p.add_argument("--url", default=None,
                           help="stream through a serve'd STREAMING artifact: "
                                "opens a /stream session, posts chunks, closes")
            p.add_argument("--ema", action="store_true",
                           help="serve the EMA parameter average the "
                                "optimizer carried (--ema-decay training)")
            _add_checkpoint_model_flags(p)
            p.add_argument("--int8", action="store_true",
                           help="int8 post-training quantization of the convs, "
                                "calibrated on the first batch (infer/quant.py)")
            p.add_argument("--int8-dense", action="store_true",
                           help="with --int8: also quantize the Dense layers")
            p.add_argument("--tile", type=int, default=256)
            p.add_argument("--chunk-len", type=int, default=8)
            p.add_argument("--ctx-frames", type=int, default=4)
            p.add_argument("--clip-len", type=int, default=16)
            p.add_argument("--height", type=int, default=720)
            p.add_argument("--width", type=int, default=1280)

    for name in ("export", "serve"):
        p = subparsers[name]
        _add_checkpoint_model_flags(p)
        p.add_argument("--clip-len", type=int, default=8)
        p.add_argument("--ema", action="store_true",
                       help="serve the EMA parameter average the optimizer "
                            "carried (--ema-decay training)")
        p.add_argument("--checkpoint", default=None)
    p = subparsers["export"]
    p.add_argument("--out", default=None, help="artifact path (.tchvp zip)")
    p.add_argument("--model", default="hybrid", choices=_EXPORT_CLIP_MODELS + _EXPORT_IMAGE_MODELS,
                   help="model family: clip models take (B,T,H,W,3), image models (B,H,W,3)")
    p.add_argument("--clippack", default=None, help="calibration source for --int8")
    p.add_argument("--int8", action="store_true",
                   help="export the int8 PTQ serving program (calibrates on one batch)")
    p.add_argument("--int8-dense", action="store_true", help="with --int8: also quantize Dense")
    p.add_argument("--platforms", default=None,
                   help="the platform the program serves on; it must be --device's")
    p.add_argument("--static-batch", action="store_true",
                   help="pin the batch dim (to 1) instead of exporting it symbolically")
    p.add_argument("--streaming", action="store_true",
                   help="export the stateful streaming carry step fn(carry, chunk) "
                        "instead of the whole-clip program; serve then exposes "
                        "/stream session endpoints (hybrid model)")
    p.add_argument("--chunk-len", type=int, default=8, help="frames per streaming chunk (--streaming)")
    p.add_argument("--ctx-frames", type=int, default=4,
                   help="previous-chunk context frames visible to each chunk's attention (--streaming)")
    p.add_argument("--stream-batch", type=int, default=1,
                   help="concurrent clips per streaming session (--streaming; static)")
    p = subparsers["serve"]
    p.add_argument("--exported", default=None, help=".tchvp artifact (export)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8765)
    p.add_argument("--buckets", default="1",
                   help="comma-separated batch buckets run at startup; requests are "
                        "padded/split to these sizes (empty string disables)")
    p.add_argument("--batch-window-ms", type=float, default=0.0,
                   help="dynamic micro-batching: coalesce concurrent requests arriving "
                        "within this window into one device batch (0 = off)")
    p.add_argument("--mesh", default=None,
                   help="axis=size pairs; data=K,pipe=N serves the flagship LIVE from --checkpoint "
                        "with the temporal stack as a GPipe pipeline over the ranks (one process a "
                        "rank; rank 0 serves HTTP)")
    p.add_argument("--model", default="hybrid", choices=("hybrid",),
                   help="live-serving model family (--mesh mode)")

    p = sub.add_parser("tune", help="autotune the attention kernels' blocks on this card")
    p.set_defaults(fn=cmd_tune)
    p.add_argument("--shape", default="8x8x2048x64",
                   help="BxHxSxDh of the attention input to tune for")
    p.add_argument("--kernels", default=None,
                   help="comma list of flash,band,halo (default: flash,band)")
    p.add_argument("--window", type=int, default=0, help="window size for band/halo kernels")
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--mode", default="fwdbwd", choices=("fwd", "fwdbwd"),
                   help="tune forward-only or forward+backward")
    p.add_argument("--iters", type=int, default=20)

    p = sub.add_parser("doctor", help="environment / runtime diagnostics")
    p.set_defaults(fn=cmd_doctor)
    p.add_argument("--smoke", action="store_true",
                   help="also run one flash-attention forward against its "
                        "plain version on the card")

    return parser, subparsers


def _init_method(coordinator: str) -> str:
    """``host:port`` -> ``tcp://host:port``; an init URL passes as given."""
    if coordinator is None:
        raise SystemExit("--num-processes > 1 needs --coordinator host:port")
    return coordinator if "://" in coordinator else f"tcp://{coordinator}"


def main(argv=None) -> None:
    parser, subparsers = _build_parser()
    raw_argv = list(sys.argv[1:]) if argv is None else list(argv)
    # --config FILE: the YAML's values become this subcommand's defaults
    # BEFORE parsing, so explicit CLI flags still win.
    cfg_path = None
    for i, tok in enumerate(raw_argv):
        if tok == "--config" and i + 1 < len(raw_argv):
            cfg_path = raw_argv[i + 1]
        elif tok.startswith("--config="):
            cfg_path = tok.split("=", 1)[1]
    if cfg_path is not None:
        cmd = next((t for t in raw_argv if not t.startswith("-")), None)
        if cmd in subparsers:
            subparsers[cmd].set_defaults(**_config_defaults(cfg_path, subparsers[cmd]))

    args = parser.parse_args(raw_argv)
    if getattr(args, "int8_dense", False) and not getattr(args, "int8", False):
        parser.error("--int8-dense requires --int8 (it extends the PTQ "
                     "engine, it does not enable it)")
    import contextlib

    import torch.distributed as dist

    joined = False
    world = getattr(args, "num_processes", 1)
    if not 0 <= getattr(args, "process_id", 0) < max(world, 1):
        raise SystemExit(f"--process-id {args.process_id}: a rank of --num-processes {world} "
                         f"is 0 to {world - 1}")
    if world > 1:
        from tchvp_tpu_torch.parallel import init_distributed, launch_line

        layout = init_distributed(_init_method(args.coordinator), world, args.process_id,
                                  device=str(_cuda_check(args)))
        joined = True
        if args.process_id == 0:
            print(launch_line(layout), flush=True)
    if getattr(args, "profile_dir", None):
        from tchvp_tpu_torch.utils import profiling

        ctx = profiling.trace(args.profile_dir)
    else:
        ctx = contextlib.nullcontext()
    try:
        with ctx:
            args.fn(args)
    finally:
        if joined and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
