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
    python -m tchvp_tpu_torch.cli pack   --train-csv clips.csv --out clips.cpk
    python -m tchvp_tpu_torch.cli summary --model hybrid
    python -m tchvp_tpu_torch.cli summary --model fct
    python -m tchvp_tpu_torch.cli summary --model combined
    python -m tchvp_tpu_torch.cli doctor --smoke

Every command that runs a model runs it on ``--device`` (default
``cuda``); without a card it exits 1 unless ``--device cpu`` is given.
``port`` and ``summary`` run no model: they build theirs on the CPU.
``--mesh seq=N`` runs as N processes, one per rank, each given
``--coordinator`` (``host:port``, or any ``torch.distributed`` init URL),
``--num-processes N`` and its ``--process-id``.

Subcommands, options and mesh axes of the JAX package that the port does
not have yet are registered and exit naming their item of ROADMAP.md
("modules to port").
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

_ITEMS = {10: "serving", 11: "parallelism", 12: "autotuner"}


def _not_ported(what: str, item: int):
    raise SystemExit(f"{what} is not ported yet (ROADMAP.md, modules to port, "
                     f"item {item}: {_ITEMS[item]})")


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
                   help="not ported yet (item 11)")
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
                   help="not ported yet (item 11)")
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


def _mesh(args):
    """The ``seq`` mesh over the launched ranks, or None. Other axes and
    ``--data-parallel`` are not ported yet."""
    import torch.distributed as dist

    from tchvp_tpu_torch.parallel import make_mesh

    axes = _parse_mesh_axes(getattr(args, "mesh", None) or "")
    others = sorted(k for k, v in axes.items() if k != "seq" and v > 1)
    if others:
        _not_ported(f"--mesh axes {others}", 11)
    if args.data_parallel:
        _not_ported("--data-parallel", 11)
    n = axes.get("seq", 1)
    if n <= 1:
        return None
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise SystemExit(
            f"--mesh {args.mesh}: {n} processes requested, {world} running "
            f"(launch one per rank with --coordinator, --num-processes {n} "
            f"and --process-id)")
    return make_mesh(("seq",), (n,))


def _device(args):
    """``--device``, checked: a CUDA device must exist (no fallback); in a
    multi-process launch with a bare ``cuda`` each rank takes card
    ``process_id % count``."""
    import torch

    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit(f"--device {args.device}: no CUDA device "
                             "(pass --device cpu to run on the CPU)")
        if dev.index is None:
            dev = torch.device("cuda", args.process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev


def _moe_flags(args) -> None:
    """The routed MoE's flags (ops/moe.py) wait for item 11: each exits
    when it is given a value, none is ignored."""
    for flag, default in (("num_experts", 0), ("moe_aux_weight", 0.01), ("router_top_k", 1)):
        if getattr(args, flag, default) != default:
            _not_ported(f"--{flag.replace('_', '-')} (ops/moe.py)", 11)


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


def _no_data_parallel(args, cmd: str) -> None:
    """``--data-parallel`` of the image flows waits for item 11."""
    if args.data_parallel:
        _not_ported(f"{cmd} --data-parallel", 11)


def _segment_mesh(args) -> None:
    """``segment``'s meshes: JAX runs ``data=`` and ``spatial=``, which
    wait for item 11 here; any other axis is refused as JAX refuses it."""
    axes = _parse_mesh_axes(getattr(args, "mesh", None) or "")
    bad = sorted(k for k, v in axes.items() if v > 1 and k not in ("data", "spatial"))
    if bad:
        raise SystemExit(f"segment: unsupported mesh axes {bad} (use data= and spatial=)")
    if any(v > 1 for v in axes.values()):
        _not_ported(f"--mesh {args.mesh}", 11)
    if args.data_parallel:
        _not_ported("--data-parallel", 11)


def _fct_attn(args) -> str:
    """``--attn-impl`` of ``segment`` (default "auto": the flash kernels on
    a card); ring attention is item 11."""
    attn = getattr(args, "attn_impl", None) or "auto"
    if attn == "ring":
        _not_ported("--attn-impl ring", 11)
    return attn


def _fct_model(device, attn: str = "auto"):
    """FCT at its default widths on ``device``, its weights from a seeded
    generator (seed 0)."""
    import torch

    from tchvp_tpu_torch.config import FCTConfig
    from tchvp_tpu_torch.models.fct import FCT

    return FCT(FCTConfig(attn_impl=attn), device=device, generator=torch.Generator().manual_seed(0))


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

    _no_data_parallel(args, "denoise")
    cfg = TrainConfig(
        loss=args.loss or "mixed",
        lr=args.lr,
        checkpoint_dir=args.checkpoint_dir,
        batch_size=args.batch_size,
        **_train_cfg_kwargs(args),
    )
    train, val, test = _image_data(args, supervised=False)
    flow = DenoisingFlow(_image_model("ae", _device(args)), cfg=cfg, image_size=args.image_size,
                         aug=_aug_cfg(args))
    _record_run(args)
    flow.fit(train, val or train, test, epochs=args.epochs, lr=args.lr)


def cmd_transfer(args) -> None:
    """Frozen-encoder mask transfer (``TransferFlow``): the encoder of the
    ``--pretrained`` Autoencoder32K checkpoint under a fresh mask decoder,
    dice loss."""
    from tchvp_tpu_torch.config import TrainConfig
    from tchvp_tpu_torch.train.loops import TransferFlow

    _no_data_parallel(args, "transfer")
    cfg = TrainConfig(
        model_name="latent_to_mask",
        loss="dice",
        checkpoint_dir=args.checkpoint_dir,
        **_train_cfg_kwargs(args),
    )
    train, _, _ = _image_data(args, supervised=True)
    flow = TransferFlow(cfg=cfg, image_size=args.image_size, device=_device(args))
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

    _segment_mesh(args)
    attn = _fct_attn(args)
    cfg = TrainConfig(
        model_name="FCT",
        loss=args.loss or "dice",
        lr=args.lr,
        checkpoint_dir=args.checkpoint_dir,
        **_train_cfg_kwargs(args),
    )
    train, _, test = _image_data(args)
    device = _device(args)
    flow = SegmentationFlow(_fct_model(device, attn), cfg=cfg, image_size=args.image_size)
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
            _not_ported(f"--mesh with --model {args.model}", 11)
        from tchvp_tpu_torch.models.frame_ae import FrameAE
        from tchvp_tpu_torch.models.resnet_ae import Autoencoder4K, Autoencoder32K

        return FrameAE(_seeded(Autoencoder32K if args.model == "ae32k" else Autoencoder4K,
                               device=device))
    _moe_flags(args)
    attn = getattr(args, "attn_impl", None) or "xla"
    if attn == "ring":
        _not_ported("--attn-impl ring", 11)
    return VideoHybridNet(flagship_video_config(
        args.image_size,
        num_layers=getattr(args, "layers", 2),
        attn_impl=attn,
        window_size=getattr(args, "window", 0),
        seq_axis=getattr(args, "seq_axis", None),
    ), device=device, generator=torch.Generator().manual_seed(0))


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
    if args.fsdp:
        _not_ported("--fsdp", 11)
    if args.qat or args.qat_dense:
        _not_ported("--qat", 10)
    cfg = TrainConfig(
        model_name="video",
        loss=args.loss or ("mse" if args.image_size <= 160 else "mixed"),
        lr=args.lr,
        checkpoint_dir=args.checkpoint_dir,
        **_train_cfg_kwargs(args),
    )
    device = _device(args)
    mesh = _mesh(args)
    args.seq_axis = "seq" if mesh is not None else None
    if args.seq_axis and not args.window and args.attn_impl != "ring":
        raise SystemExit(
            "--mesh seq=N needs --window W (windowed/flash sequence "
            "parallelism) or --attn-impl ring (full attention)"
        )
    model = _video_model(args, device)
    flow = VideoFlow(
        model, cfg=cfg, image_size=args.image_size, mesh=mesh,
        accum_steps=args.accum_steps,
        remat_policy=args.remat_policy,
        seq_axis=args.seq_axis,
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


def _serving_flags(args) -> None:
    """The serving options of the JAX package that wait for item 10."""
    if getattr(args, "url", None):
        _not_ported("--url (infer/server.py)", 10)
    if getattr(args, "exported", None):
        _not_ported("--exported (infer/export.py)", 10)
    if getattr(args, "int8", False):
        _not_ported("--int8 (infer/quant.py)", 10)


def _serving_model(args, size: int, device):
    """The bf16 model of the serving commands (the JAX package's
    ``VideoHybridNet(dtype=bfloat16)``; "xla" attention), or with ``--model
    ae32k|ae4k`` the frame AE cast to bf16, with the checkpoint's weights
    (fp32 on disk, cast on load) when one is given."""
    import torch

    from tchvp_tpu_torch.config import flagship_video_config
    from tchvp_tpu_torch.models.video import VideoHybridNet
    from tchvp_tpu_torch.train import checkpoint as ckpt

    _moe_flags(args)
    if args.model != "hybrid":
        model = _video_model(args, device).to(torch.bfloat16)
    else:
        model = VideoHybridNet(flagship_video_config(image_size=size, num_layers=args.layers),
                               device=device, dtype=torch.bfloat16,
                               generator=torch.Generator().manual_seed(0))
    if args.checkpoint:
        restored = ckpt.restore_state(args.checkpoint)
        model.load_state_dict(_restored_params(restored, args.ema, args.layers))
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


def cmd_stream(args) -> None:
    """Streaming long-video inference: tile -> chunked carry -> untile.

    Processes clips from a clippack (or synthetic frames) through a
    trained or fresh bf16 VideoHybridNet at any resolution; reports
    throughput."""
    import numpy as np
    import torch

    from tchvp_tpu_torch.models.streaming import StreamingConfig, make_streamer

    _serving_flags(args)
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
    device = _device(args)
    scfg = StreamingConfig(
        tile=args.tile, chunk_len=args.chunk_len, ctx_frames=args.ctx_frames
    )
    model = _serving_model(args, args.tile, device)
    streamer = make_streamer(model, scfg, mesh=_mesh(args))

    frames = 0
    t0 = None
    for batch in data:
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
    (the BASELINE config-2 spec-batch path)."""
    import numpy as np
    import torch

    from tchvp_tpu_torch.data.pipeline import preprocess_clip
    from tchvp_tpu_torch.models.streaming import microbatched_infer
    from tchvp_tpu_torch.utils.imaging import save_side_by_side

    _serving_flags(args)
    size = args.image_size
    device = _device(args)
    if _mesh(args) is not None:
        _not_ported("infer --mesh", 11)
    data = _clip_data(args, size)
    model = _serving_model(args, size, device)

    frames, psnrs, t0 = 0, [], None
    for bi, batch in enumerate(data):
        raw = torch.as_tensor(np.asarray(batch, dtype=np.uint8)).to(device)
        with torch.inference_mode():
            clip = preprocess_clip(raw, size, dtype=torch.bfloat16)
            if args.microbatch:
                recon = microbatched_infer(model, clip, args.microbatch)
            else:
                recon = model(clip)[1]
            mse = torch.mean((clip.float() - recon.float()) ** 2)
            psnr = -10.0 * torch.log10(torch.clamp(mse, min=1e-12))
        psnrs.append(float(psnr))  # sync
        if t0 is None:
            t0 = time.perf_counter()  # exclude the warm-up batch
        else:
            frames += raw.shape[0] * raw.shape[1]
        if bi == 0 and args.out_dir:
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


def _validate_restored_depth(state_dict, expect_layers: int) -> None:
    """Reject a temporal-depth mismatch between a restored checkpoint and
    the ``--layers`` model loudly, with the JAX package's message."""
    layers = {int(k.split(".")[2]) for k in state_dict if k.startswith("temporal.layers.")}
    if not layers:
        return  # not a hybrid checkpoint
    depth = 1 + max(layers)
    if depth != expect_layers:
        raise SystemExit(
            f"checkpoint temporal depth is {depth} layers but the model "
            f"was built with --layers {expect_layers}; pass --layers {depth}"
        )


def _restored_params(restored: dict, ema: bool, expect_layers=None):
    """The model ``state_dict`` of a ``restore_state`` payload, or with
    ``--ema`` the EMA parameter average the optimizer carried over the
    checkpoint's BatchNorm stats. With ``expect_layers`` the temporal
    depth is checked against the ``--layers`` model."""
    from tchvp_tpu_torch.train.state import ema_state_dict

    payload = restored["model"]
    if ema:
        e = (restored.get("opt_state") or {}).get("ema")
        if e is None:
            raise SystemExit(
                "--ema: checkpoint carries no EMA state (train with --ema-decay)"
            )
        payload = ema_state_dict(payload, e)
    if expect_layers is not None:
        _validate_restored_depth(payload, expect_layers)
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
    if args.int8:
        _not_ported("--int8 (infer/quant.py)", 10)
    path = args.checkpoint or ckpt.latest_step_dir(args.checkpoint_dir)
    src = f"ckpt {path}" if path else "fresh params (no checkpoint found)"
    device = _device(args)

    def load(model):
        if path:
            raw = ckpt.restore_state(path)
            if "step" not in raw and args.ema:
                raise SystemExit("--ema needs a full-state checkpoint, got weights-only")
            model.load_state_dict(_restored_params(raw, args.ema, args.layers))

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
    psnr = flow.evaluate(_clip_data(args, args.image_size))
    print(f"eval {args.model}: reconstruction PSNR {psnr:.2f} dB  [{src}]")


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


def _unported_command(item: int):
    def run(args) -> None:
        _not_ported(f"the {args.cmd} command", item)

    return run


# Subcommands of the JAX package whose item is still to come. They take
# whatever follows them (``main`` parses them with ``parse_known_args``) and
# exit naming the item.
_UNPORTED = {"export": 10, "serve": 10, "shards": 11, "tune": 12}


def _build_parser():
    parser = argparse.ArgumentParser("tchvp_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    subparsers = {}
    commands = {"video": cmd_video, "segment": cmd_segment, "denoise": cmd_denoise,
                "transfer": cmd_transfer, "port": cmd_port, "pack": cmd_pack,
                "stream": cmd_stream, "infer": cmd_infer, "eval": cmd_eval, "summary": cmd_summary}

    for name, item in _UNPORTED.items():
        p = sub.add_parser(name, help=f"not ported yet (item {item})")
        p.set_defaults(fn=_unported_command(item))
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
                                "seq=N (sequence-parallel windowed attention, "
                                "one process per rank); other axes are item 11")
            p.add_argument("--layers", type=int, default=2,
                           help="temporal transformer depth (hybrid model)")
            p.add_argument("--attn-impl", default="xla",
                           choices=("xla", "flash", "windowed", "auto", "ring"),
                           help="temporal-attention core (hybrid model); "
                                "flash = the hand-written kernels")
            p.add_argument("--window", type=int, default=0,
                           help="attention window (tokens); 0 = full. "
                                "Required for --mesh seq=N")
            p.add_argument("--num-experts", type=int, default=0,
                           help="not ported yet (item 11)")
            p.add_argument("--moe-aux-weight", type=float, default=0.01)
            p.add_argument("--router-top-k", type=int, default=1)
            p.add_argument("--fsdp", action="store_true", help="not ported yet (item 11)")
            p.add_argument("--accum-steps", type=int, default=1,
                           help="gradient accumulation: split each batch "
                                "into N microbatches, one optimizer update")
            p.add_argument("--qat", action="store_true", help="not ported yet (item 10)")
            p.add_argument("--qat-dense", action="store_true", help="not ported yet (item 10)")
            p.add_argument("--remat-policy", default="none",
                           choices=("none", "full", "stages", "dots"),
                           help="rematerialization policy for the train "
                                "step (torch.utils.checkpoint)")
        if name == "segment":
            p.add_argument("--mesh", default=None,
                           help="axis=size pairs; JAX's data= and spatial= are "
                                "not ported yet (item 11)")
            p.add_argument("--attn-impl", default=None,
                           choices=("auto", "xla", "flash", "ring"),
                           help="FCT spatial-attention core (default auto: the "
                                "flash kernels on a card); ring is item 11")
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
            p.add_argument("--mesh", default=None, help="not ported yet (item 11)")
            p.add_argument("--ema", action="store_true",
                           help="serve the EMA parameter average the "
                                "optimizer carried (--ema-decay training) "
                                "instead of the live params")
            _add_checkpoint_model_flags(p)
            p.add_argument("--exported", default=None, help="not ported yet (item 10)")
            p.add_argument("--url", default=None, help="not ported yet (item 10)")
            p.add_argument("--clip-len", type=int, default=8)
            p.add_argument("--microbatch", type=int, default=0)
            p.add_argument("--out-dir", default=None)
            p.add_argument("--int8", action="store_true", help="not ported yet (item 10)")
            p.add_argument("--int8-dense", action="store_true", help="not ported yet (item 10)")
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
            p.add_argument("--int8", action="store_true", help="not ported yet (item 10)")
            p.add_argument("--int8-dense", action="store_true", help="not ported yet (item 10)")
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
        if name == "stream":
            p.add_argument("--clippack", default=None)
            p.add_argument("--checkpoint", default=None)
            p.add_argument("--url", default=None, help="not ported yet (item 10)")
            p.add_argument("--ema", action="store_true",
                           help="serve the EMA parameter average the "
                                "optimizer carried (--ema-decay training)")
            _add_checkpoint_model_flags(p)
            p.add_argument("--int8", action="store_true", help="not ported yet (item 10)")
            p.add_argument("--int8-dense", action="store_true", help="not ported yet (item 10)")
            p.add_argument("--tile", type=int, default=256)
            p.add_argument("--chunk-len", type=int, default=8)
            p.add_argument("--ctx-frames", type=int, default=4)
            p.add_argument("--clip-len", type=int, default=16)
            p.add_argument("--height", type=int, default=720)
            p.add_argument("--width", type=int, default=1280)

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

    args, rest = parser.parse_known_args(raw_argv)
    if rest and args.cmd not in _UNPORTED:
        parser.error(f"unrecognized arguments: {' '.join(rest)}")
    if getattr(args, "int8_dense", False) and not getattr(args, "int8", False):
        parser.error("--int8-dense requires --int8 (it extends the PTQ "
                     "engine, it does not enable it)")
    import contextlib

    import torch.distributed as dist

    joined = False
    if getattr(args, "num_processes", 1) > 1:
        import torch

        from tchvp_tpu_torch.parallel import init_distributed

        device = _device(args)
        backend = ("nccl" if device.type == "cuda"
                   and torch.cuda.device_count() >= args.num_processes else "gloo")
        init_distributed(_init_method(args.coordinator), args.num_processes,
                         args.process_id, backend=backend)
        joined = True
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
