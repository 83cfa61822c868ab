"""``python -m tchvp_tpu_torch.cli`` against ``tchvp_tpu.cli`` on the CPU.

* ``video``: one JAX run and one port run of the same flags (32^2,
  ``--layers 1``, 2 epochs, ``--save-every 1 --keep-checkpoints 1``) leave
  the same ``step_*`` tags and ``TAG_SCHEME``, a ``run.json`` whose
  resolved flags are JAX's (less the mesh axes the port does not have,
  plus ``--device``), and event files with the same tags at the same
  steps. ``--resume --epochs 3`` starts at epoch 3.
* JAX's checkpoint, converted by ``convert.from_flax_state`` and saved by
  the port: ``eval`` prints JAX's PSNR (both print 2 decimals: within
  0.011 dB) and ``infer`` (bf16 in both) JAX's within 0.05 dB; ``--layers
  2`` exits with JAX's message.
* ``stream``, ``summary`` (its counts equal the flax parameter subtrees'),
  ``pack`` -> ``video --clippack --save-every-steps``, ``doctor``.
* ``--config`` errors read as JAX's; a missing PyYAML is named; every
  unported subcommand, option and mesh axis exits naming its item of
  ROADMAP.md (11 or 12; the serving options of item 10 run); without a
  CUDA device every model command exits 1.
* ``video --mesh seq=2 --window 64 --attn-impl flash`` as two gloo ranks
  (``tests/torch_dist.py``), dropout off in both runs (the flash route
  draws one seed per shard): the halo path ran on both ranks, and rank 0's
  checkpoint after one SGD (lr 1) step equals a one-process run of the
  same flags without the mesh: parameters within 1.9 x 2e-2 x the largest
  gradient (the limit of ``tests/test_torch_seq_parallel.py``), BatchNorm
  stats within 1e-5.
* ``video --mesh seq=2 --attn-impl ring`` and ``video --mesh expert=2
  --num-experts 4`` the same way, against one process of the same flags
  without the mesh (the ring's against ``--attn-impl xla``): the ring and
  the expert-parallel layer ran on both ranks, and rank 0's checkpoint
  (the experts gathered whole) equals the one-process run's at the same
  limits.
"""

import contextlib
import io
import json
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_dist
from tchvp_tpu import cli as jcli
from tchvp_tpu.config import flagship_video_config as jflagship
from tchvp_tpu.models import VideoHybridNet as JVideoHybridNet
from tchvp_tpu.train import checkpoint as jckpt
from tchvp_tpu.train.state import param_count as jparam_count
from tchvp_tpu_torch import cli, convert
from tchvp_tpu_torch.config import TrainConfig
from tchvp_tpu_torch.data.synthetic import SyntheticClips
from tchvp_tpu_torch.train import checkpoint as ckpt
from tchvp_tpu_torch.train.loops import VideoFlow
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

SMALL = ["--image-size", "32", "--layers", "1", "--batch-size", "1", "--clip-len", "4"]
TRAIN = ["video", "--synthetic", "2", "--epochs", "2", "--save-every", "1",
         "--keep-checkpoints", "1", *SMALL]
CPU = ["--device", "cpu"]


def run(main, argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


def psnr_of(text: str) -> float:
    return float(re.search(r"PSNR (-?[0-9.]+) dB", text).group(1))


def tags(d) -> list:
    return sorted(x for x in os.listdir(d) if x.startswith("step_"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's and the port's ``video`` runs of TRAIN, each in its own
    working directory (runs/ is relative to it), JAX's eval and infer on
    its checkpoint, and that checkpoint converted into the port's format."""
    base = tmp_path_factory.mktemp("cli")
    cwd = os.getcwd()
    out = {}
    try:
        for name, main, extra in (("jax", jcli.main, []), ("torch", cli.main, CPU)):
            os.makedirs(base / name)
            os.chdir(base / name)
            out[name] = run(main, TRAIN + ["--checkpoint-dir", str(base / name / "ckpt")] + extra)
        jstep = str(base / "jax" / "ckpt" / "step_2")
        serve = ["--synthetic", "2", *SMALL, "--checkpoint"]
        out["jax_eval"] = run(jcli.main, ["eval", *serve, jstep])
        out["jax_infer"] = run(jcli.main, ["infer", *serve, jstep])
        with pytest.raises(SystemExit) as err:
            jcli.main(["eval", *serve, jstep, "--layers", "2"])
        out["jax_layers"] = str(err.value.code)
    finally:
        os.chdir(cwd)
    flow = VideoFlow(cli._video_model(cli._build_parser()[0].parse_args(["video", *SMALL]), "cpu"),
                     cfg=TrainConfig(model_name="video", loss="mse"), image_size=32)
    flow.init_state(4)
    ckpt.load_payload(flow.state, convert.from_flax_state(jckpt.restore_state(jstep)))
    out["converted"] = ckpt.save_state(str(base / "converted"), 2, flow.state)
    out["base"] = base
    return out


def test_video_writes_what_jax_writes(runs):
    base = runs["base"]
    jdir, tdir = base / "jax" / "ckpt", base / "torch" / "ckpt"
    assert tags(tdir) == tags(jdir) == ["step_2"]
    assert (tdir / "TAG_SCHEME").read_text() == (jdir / "TAG_SCHEME").read_text() == "epochs"
    assert re.findall(r"Video epoch \d+", runs["torch"]) == re.findall(r"Video epoch \d+", runs["jax"])
    jrec, trec = (json.loads((d / "run.json").read_text()) for d in (jdir, tdir))
    jargs, targs = jrec["resolved_args"], trec["resolved_args"]
    assert set(targs) == set(jargs) | {"device"}
    assert {k: v for k, v in targs.items() if k not in ("checkpoint_dir", "device")} == \
        {k: v for k, v in jargs.items() if k in targs and k != "checkpoint_dir"}
    assert trec["command"] == jrec["command"] == "video"
    assert trec["environment"]["device_name"] == "cpu"
    logs = {}
    for name in ("jax", "torch"):
        d = base / name / "runs" / "video"
        assert len([f for f in os.listdir(d) if f.startswith("events.out.tfevents.")]) == 1
        logs[name] = [(r["tag"], r["step"]) for r in map(json.loads, (d / "metrics.jsonl").open())]
    assert logs["torch"] == logs["jax"] == [("Loss/Train", 1), ("PSNR/Train", 1),
                                            ("Loss/Train", 2), ("PSNR/Train", 2)]


def test_resume_starts_at_the_next_epoch(runs, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    d = str(tmp_path / "ckpt")
    run(cli.main, TRAIN + CPU + ["--checkpoint-dir", d])
    text = run(cli.main, TRAIN + CPU + ["--checkpoint-dir", d, "--resume", "--epochs", "3"])
    assert re.findall(r"Video epoch \d+", text) == ["Video epoch 3"]
    assert tags(d) == ["step_3"]


def test_eval_and_infer_of_a_converted_jax_checkpoint_give_jax_psnr(runs):
    serve = ["--synthetic", "2", *SMALL, *CPU, "--checkpoint", runs["converted"]]
    got = psnr_of(run(cli.main, ["eval", *serve]))
    assert abs(got - psnr_of(runs["jax_eval"])) <= 0.011
    got = psnr_of(run(cli.main, ["infer", *serve]))
    assert abs(got - psnr_of(runs["jax_infer"])) <= 0.05
    with pytest.raises(SystemExit) as err:
        cli.main(["eval", *serve, "--layers", "2"])
    assert str(err.value.code) == runs["jax_layers"]
    with pytest.raises(SystemExit, match="no EMA state"):
        cli.main(["infer", *serve, "--ema"])


def test_ema_microbatch_and_out_dir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    run(cli.main, ["video", "--synthetic", "2", "--epochs", "1", "--lr", "0.01", "--ema-decay", "0.5",
                   *SMALL, *CPU])
    raw = ckpt.restore_state("checkpoints/step_1")
    serve = ["--synthetic", "2", *SMALL, *CPU, "--checkpoint", "checkpoints/step_1"]
    want = {}
    for ema in (True, False):
        flow = VideoFlow(cli._video_model(cli._build_parser()[0].parse_args(["video", *SMALL]), "cpu"),
                         cfg=TrainConfig(model_name="video", loss="mse"), image_size=32)
        flow.init_state(4)
        flow.model.load_state_dict(cli._restored_params(raw, ema=ema, expect_layers=1))
        want[ema] = flow.evaluate(SyntheticClips(1, 4, 32, 2))
    assert abs(want[True] - want[False]) > 0.05  # the EMA is not the live weights
    assert abs(psnr_of(run(cli.main, ["eval", *serve, "--ema"])) - want[True]) <= 0.006
    assert abs(psnr_of(run(cli.main, ["eval", *serve])) - want[False]) <= 0.006
    one = psnr_of(run(cli.main, ["infer", *serve, "--ema", "--batch-size", "2", "--out-dir", "dumps"]))
    micro = psnr_of(run(cli.main, ["infer", *serve, "--ema", "--batch-size", "2", "--microbatch", "1"]))
    assert abs(one - micro) <= 0.05 and sorted(os.listdir("dumps")) == [
        f"clip0_frame{t}.jpg" for t in range(4)]


def test_stream_summary_and_doctor(runs, tmp_path):
    text = run(cli.main, ["stream", "--synthetic", "2", "--batch-size", "1", "--clip-len", "8",
                          "--height", "40", "--width", "72", "--tile", "32", "--layers", "1",
                          *CPU, "--checkpoint", runs["converted"]])
    assert re.search(r"streamed 8 frames @ 40x72: [0-9.]+ frames/s", text), text
    text = run(cli.main, ["summary", "--image-size", "32", "--layers", "1", "--depth", "1"])
    jmodel = JVideoHybridNet(config=jflagship(32, num_layers=1))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, 2, 32, 32, 3)))["params"]
    for name in ("encoder", "temporal", "decoder"):
        row = re.search(rf"^{name}\s+\w+\s+([0-9,]+)$", text, re.M)
        assert int(row.group(1).replace(",", "")) == jparam_count(shapes[name]), name
    total = int(re.search(r"parameters \(([0-9,]+)\)", text).group(1).replace(",", ""))
    assert total == jparam_count(shapes)
    assert "Input: (1, 8, 32, 32, 3) float32" in text
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp_:
        mp_.setattr(torch.cuda, "is_available", lambda: False)
        with contextlib.redirect_stdout(out), pytest.raises(SystemExit, match="no CUDA device"):
            cli.main(["doctor", "--smoke"])
    assert f"torch {torch.__version__}" in out.getvalue()
    assert "native clippack loader: OK" in out.getvalue()


def test_pack_then_mid_epoch_checkpoints(tmp_path, monkeypatch):
    from PIL import Image

    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(0)
    rows = []
    for c in range(3):
        paths = []
        for t in range(4):
            p = tmp_path / f"c{c}_{t}.png"
            Image.fromarray(rng.integers(0, 256, (40, 40, 3), dtype=np.uint8)).save(p)
            paths.append(str(p))
        rows.append(",".join(paths))
    (tmp_path / "clips.csv").write_text("\n".join(rows) + "\n")
    text = run(cli.main, ["pack", "--train-csv", "clips.csv", "--out", "clips.cpk", "--image-size", "32",
                          "--clip-len", "4"])
    assert text.strip() == "packed 3 clips x 4 frames -> clips.cpk"
    run(cli.main, ["video", "--clippack", "clips.cpk", "--epochs", "1", "--save-every-steps", "2",
                   *SMALL, *CPU])
    assert tags("checkpoints") == ["step_2", "step_3"]
    assert (tmp_path / "checkpoints" / "TAG_SCHEME").read_text() == "steps"
    extra = ckpt.restore_state("checkpoints/step_2")["extra"]
    assert extra == {"train_epoch": 1, "data_position": {"epoch": 0, "batch": 2}}


# ---------------------------------------------------------- refusals, errors


@pytest.mark.parametrize("body,case", [
    ("bogus: 1\n", "unknown key"),
    ("epochs: many\n", "bad type"),
    ("optimizer: rmsprop\n", "bad choice"),
    ("resume: 3\n", "bad bool"),
    ("- 1\n- 2\n", "not a mapping"),
])
def test_config_errors_read_as_jax(tmp_path, body, case):
    path = tmp_path / "c.yaml"
    path.write_text(body)
    msgs = []
    for main in (jcli.main, cli.main):
        with pytest.raises(SystemExit) as err:
            main(["video", "--config", str(path), *CPU])
        msgs.append(str(err.value.code))
    if case == "unknown key":  # the port lists one flag more: --device
        head = msgs[0].split("(valid:")[0]
        assert msgs[1].startswith(head)
        valid = [set(m.split("(valid: ")[1].rstrip(")").split(", ")) for m in msgs]
        assert valid[1] == valid[0] | {"device"}
    else:
        assert msgs[1] == msgs[0]


def test_config_applies_and_names_pyyaml(tmp_path, monkeypatch):
    path = tmp_path / "c.yaml"
    path.write_text("epochs: 1\nsave-every: 1\nimage_size: 32\n")
    monkeypatch.chdir(tmp_path)
    text = run(cli.main, ["video", "--config", str(path), "--synthetic", "1", "--layers", "1",
                          "--batch-size", "1", "--clip-len", "4", *CPU])
    assert re.findall(r"Video epoch \d+", text) == ["Video epoch 1"]
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(SystemExit, match="PyYAML"):
        cli.main(["video", "--config", str(path), *CPU])


MODEL_ARGS = ["--synthetic", "1", *SMALL, *CPU]
# item None: ported since (the conv families, item 7; serving, item 10; the
# MoE flags, item 11b; --attn-impl ring, item 11a, which without --mesh
# seq=N exits saying so; --mesh data=N and --data-parallel, item 11c, and
# --mesh model=N, spatial=N and pipe=N, item 11e and 11f, which need N
# processes; serve --mesh pipe=N, item 11f, which refuses --exported;
# --fsdp, item 11d, which without a data mesh exits saying so; tune, item
# 12, which needs a card; shards and stream --data-parallel, item 11g): the
# command runs, or exits with a message of its own, and is not refused.
STREAM_SMALL = ["--tile", "32", "--height", "32", "--width", "32", "--chunk-len", "2", "--ctx-frames", "1"]
UNPORTED = [
    (["denoise"], None), (["transfer"], None), (["port"], None),
    (["export"], None), (["serve"], None), (["shards"], None), (["tune"], None),
    (["video", "--model", "ae32k"], None), (["video", "--fsdp"], None), (["video", "--data-parallel", "--fsdp"], None),
    (["video", "--qat"], None),
    (["video", "--mesh", "model=2"], None), (["video", "--mesh", "data=2,model=2"], None),
    (["video", "--mesh", "spatial=2"], None), (["video", "--mesh", "pipe=2"], None),
    (["video", "--num-experts", "2"], None), (["video", "--mesh", "data=2"], None),
    (["video", "--data-parallel"], None), (["video", "--attn-impl", "ring"], None),
    (["eval", "--model", "unet"], None), (["eval", "--int8"], None),
    (["infer", "--exported", "a.tchvp"], None), (["infer", "--url", "http://localhost:1"], None),
    (["infer", "--int8"], None), (["infer", "--mesh", "pipe=2"], None),
    (["stream", "--int8", *STREAM_SMALL], None), (["stream", "--url", "http://localhost:1"], None),
    (["stream", "--data-parallel", *STREAM_SMALL], None),
    (["summary", "--model", "unet"], None), (["summary", "--model", "ae32k"], None),
    (["export", "--out", "m.tchvp", "--int8", *MODEL_ARGS], None),
    (["serve", "--port", "8765", "--buckets", "1,2"], None),
    (["serve", "--exported", "m.tchvp", "--data-parallel"], None),
    (["serve", "--exported", "m.tchvp", "--mesh", "pipe=2"], None),
    (["tune", "--shape", "8x8x2048x64", "--mode", "fwd"], None),
    (["segment", "--mesh", "data=2", "--attn-impl", "flash"], None),
    (["segment", "--mesh", "spatial=2"], None), (["segment", "--attn-impl", "ring"], None),
    (["segment", "--data-parallel"], None), (["denoise", "--data-parallel"], None),
    (["transfer", "--data-parallel"], None),
    (["video", "--moe-aux-weight", "0.02"], None), (["video", "--router-top-k", "2"], None),
    (["infer", "--router-top-k", "2"], None), (["eval", "--num-experts", "4"], None),
]


@pytest.mark.parametrize("argv,item", UNPORTED, ids=lambda x: "_".join(x) if isinstance(x, list) else "")
def test_unported_exits_naming_its_item(tmp_path, monkeypatch, argv, item):
    monkeypatch.chdir(tmp_path)
    models = ("video", "eval", "infer", "stream", "summary")
    argv = argv + MODEL_ARGS if argv[0] in models else argv
    if item is None:
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                cli.main(argv)
        except SystemExit as err:
            assert "not ported yet" not in str(err.code)
        return
    with pytest.raises(SystemExit) as err:
        cli.main(argv)
    assert f"item {item}" in str(err.value.code) and "not ported yet" in str(err.value.code)


def test_int8_dense_alone_is_a_parse_error():
    with pytest.raises(SystemExit) as err:
        cli.main(["infer", "--int8-dense", *CPU])
    assert err.value.code == 2


@pytest.mark.parametrize("cmd", ["video", "infer"])
def test_an_unknown_flag_of_a_ported_command_is_a_parse_error(cmd, capsys):
    with pytest.raises(SystemExit) as err:
        cli.main([cmd, "--pretrained", "x", *CPU])
    assert err.value.code == 2 and "unrecognized arguments: --pretrained x" in capsys.readouterr().err


@pytest.mark.parametrize("cmd", ["video", "infer", "eval", "stream"])
def test_no_cuda_device_exits_1(tmp_path, monkeypatch, cmd):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as err:
        cli.main([cmd, "--synthetic", "1", *SMALL])
    assert "no CUDA device" in str(err.value.code)  # a message: exit status 1


# -------------------------------------------------------------- seq mesh


def test_seq_mesh_two_ranks_match_one_process(tmp_path, monkeypatch):
    from tchvp_tpu_torch import config

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(config, "flagship_video_config", torch_dist.flagship_without_dropout)
    argv = ["video", "--synthetic", "1", "--epochs", "1", "--image-size", "32", "--layers", "1",
            "--batch-size", "1", "--clip-len", "16", "--window", "64", "--attn-impl", "flash",
            "--optimizer", "sgd", "--lr", "1", "--device-prefetch", "0", *CPU]
    single = run(cli.main, argv + ["--checkpoint-dir", str(tmp_path / "one")])
    mp.spawn(torch_dist.run_cli, nprocs=2, join=True,
             args=(2, str(tmp_path / "rendezvous"), str(tmp_path),
                   argv + ["--mesh", "seq=2", "--checkpoint-dir", str(tmp_path / "two")]))
    for r in range(2):
        res = torch.load(tmp_path / f"cli_rank{r}.pt", weights_only=False)
        assert {"windowed_mha_halo", "flash_halo_plain", "flash_halo_bwd_plain"} <= res["seen"], res["seen"]
        assert not res["jax_loaded"]
    assert tags(tmp_path / "two") == tags(tmp_path / "one") == ["step_1"]
    one = ckpt.restore_state(str(tmp_path / "one" / "step_1"))["model"]
    two = ckpt.restore_state(str(tmp_path / "two" / "step_1"))["model"]
    init = cli._video_model(cli._build_parser()[0].parse_args(argv), "cpu").state_dict()
    grads = {k: (init[k] - one[k]) / 1.9 for k in one if "running" not in k and "num_batches" not in k}
    atol = 1.9 * 2e-2 * max(g.abs().max().item() for g in grads.values())
    for k in one:
        tol = atol if k in grads else 1e-5
        torch.testing.assert_close(two[k], one[k], atol=tol, rtol=0, msg=k)
    assert "Video epoch 1" in single


@pytest.mark.parametrize("case,mesh,single,marker", [
    ("ring", ["--attn-impl", "ring", "--mesh", "seq=2"], ["--attn-impl", "xla"], "ring_shard_map"),
    ("expert", ["--num-experts", "4", "--mesh", "expert=2"], ["--num-experts", "4"], "moe_ep_shard_map"),
], ids=["ring", "expert"])
def test_ring_and_expert_meshes_two_ranks_match_one_process(tmp_path, monkeypatch, case, mesh, single, marker):
    from tchvp_tpu_torch import config

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(config, "flagship_video_config", torch_dist.flagship_without_dropout)
    argv = ["video", "--synthetic", "1", "--epochs", "1", "--image-size", "32", "--layers", "1",
            "--batch-size", "1", "--clip-len", "16", "--optimizer", "sgd", "--lr", "1",
            "--device-prefetch", "0", *CPU]
    run(cli.main, argv + single + ["--checkpoint-dir", str(tmp_path / "one")])
    mp.spawn(torch_dist.run_cli, nprocs=2, join=True,
             args=(2, str(tmp_path / "rendezvous"), str(tmp_path),
                   argv + mesh + ["--checkpoint-dir", str(tmp_path / "two")]))
    for r in range(2):
        res = torch.load(tmp_path / f"cli_rank{r}.pt", weights_only=False)
        assert marker in res["seen"], res["seen"]
        assert not res["jax_loaded"]
    assert tags(tmp_path / "two") == tags(tmp_path / "one") == ["step_1"]
    one = ckpt.restore_state(str(tmp_path / "one" / "step_1"))["model"]
    two = ckpt.restore_state(str(tmp_path / "two" / "step_1"))["model"]
    init = cli._video_model(cli._build_parser()[0].parse_args(argv + single), "cpu").state_dict()
    assert one.keys() == two.keys() == init.keys()
    grads = {k: (init[k] - one[k]) / 1.9 for k in one if "running" not in k and "num_batches" not in k}
    atol = 1.9 * 2e-2 * max(g.abs().max().item() for g in grads.values())
    for k in one:
        assert two[k].shape == one[k].shape, k
        torch.testing.assert_close(two[k], one[k], atol=atol if k in grads else 1e-5, rtol=0, msg=k)


# -------------------------------------------------- spatial and pipe meshes


SP_ARGV = ["--synthetic", "1", "--epochs", "1", "--image-size", "32", "--layers", "2", "--batch-size", "2",
           "--clip-len", "2", "--optimizer", "sgd", "--lr", "1", "--device-prefetch", "0", *CPU]
SEG_ARGV = ["segment", "--synthetic", "1", "--epochs", "1", "--image-size", "64", "--batch-size", "2",
            "--optimizer", "sgd", "--lr", "1", "--device-prefetch", "0", *CPU]
INFER_ARGV = ["infer", "--synthetic", "2", "--image-size", "32", "--layers", "2", "--batch-size", "2",
              "--clip-len", "2", "--int8", *CPU]
STREAM_ARGV = ["stream", "--synthetic", "2", "--batch-size", "2", "--clip-len", "2", "--layers", "1",
               *STREAM_SMALL, *CPU]


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """``video --mesh spatial=2``, ``segment --mesh spatial=2 --attn-impl
    ring``, ``video --mesh pipe=2``, ``infer --mesh pipe=2 --int8`` and
    ``segment --mesh spatial=2 --attn-impl xla`` and ``stream
    --data-parallel`` as two gloo ranks (one spawn; dropout and input noise
    off for the videos), and each one's one-process counterpart."""
    from tchvp_tpu_torch import config
    from tchvp_tpu_torch.train import steps as tsteps

    tmp = tmp_path_factory.mktemp("mesh_cli")
    cwd = os.getcwd()
    os.chdir(tmp)
    argvs = [["video", *SP_ARGV, "--mesh", "spatial=2", "--attn-impl", "flash", "--checkpoint-dir", str(tmp / "sp")],
             SEG_ARGV + ["--mesh", "spatial=2", "--attn-impl", "ring", "--checkpoint-dir", str(tmp / "seg_sp")],
             ["video", *SP_ARGV, "--mesh", "pipe=2", "--attn-impl", "flash", "--checkpoint-dir", str(tmp / "pp")],
             INFER_ARGV + ["--mesh", "pipe=2", "--checkpoint", str(tmp / "pp" / "step_1")],
             SEG_ARGV + ["--mesh", "spatial=2", "--attn-impl", "xla", "--checkpoint-dir", str(tmp / "seg_sp_xla")],
             STREAM_ARGV + ["--data-parallel"]]
    try:
        mp.spawn(torch_dist.run_cli_sequence, nprocs=2, join=True,
                 args=(2, str(tmp / "rendezvous"), str(tmp), argvs))
        real = (config.flagship_video_config, tsteps.make_video_train_step, tsteps.make_pipelined_video_train_step)
        config.flagship_video_config = torch_dist.flagship_without_dropout
        torch_dist.without_noise(tsteps)
        try:
            one = {"video": run(cli.main, ["video", *SP_ARGV, "--attn-impl", "flash",
                                           "--checkpoint-dir", str(tmp / "one")]),
                   "segment": run(cli.main, SEG_ARGV + ["--attn-impl", "xla", "--checkpoint-dir", str(tmp / "seg_one")]),
                   "infer": run(cli.main, INFER_ARGV + ["--checkpoint", str(tmp / "one" / "step_1")]),
                   "stream": run(cli.main, STREAM_ARGV)}
        finally:
            config.flagship_video_config, tsteps.make_video_train_step, tsteps.make_pipelined_video_train_step = real
    finally:
        os.chdir(cwd)
    ranks = [torch.load(tmp / f"cli_seq_rank{r}.pt", weights_only=False) for r in range(2)]
    return tmp, ranks, one


def _held_to_one(many: dict, one: dict, init: dict) -> None:
    """A mesh's checkpoint against one process's, SGD lr 1 (its first
    Nesterov step moves a weight by 1.9 x its gradient): the parameters
    within 2e-2 of the largest gradient (train-mode BatchNorm rounding), the
    stats within 1e-5."""
    grads = {k: (init[k] - one[k]) / 1.9 for k in one if "running" not in k and "num_batches" not in k}
    atol = 1.9 * 2e-2 * max(g.abs().max().item() for g in grads.values())
    assert many.keys() == one.keys()
    for k in one:
        torch.testing.assert_close(many[k], one[k], atol=atol if k in grads else 1e-5, rtol=0, msg=k)


@pytest.mark.parametrize("index,name,markers", [
    (0, "sp", {"sp_constrain_conv", "sp_halo", "sp_gather", "flash_mha_plain"}),
    (2, "pp", {"pipeline_shard_map", "pp_constrain", "flash_mha_plain"}),
], ids=["spatial2", "pipe2"])
def test_video_spatial_and_pipe_meshes_two_ranks_match_one_process(mesh_runs, index, name, markers):
    """``video --mesh spatial=2`` and ``--mesh pipe=2`` as two ranks: the
    markers, and the checkpoint (the pipelined one read whole and merged)
    against one process's on the same batch."""
    from tchvp_tpu_torch.parallel import pipeline as ppl

    tmp, ranks, _ = mesh_runs
    for r in ranks:
        assert markers <= r["runs"][index]["seen"], sorted(r["runs"][index]["seen"])
        assert not r["jax_loaded"]
    one = ckpt.restore_state(str(tmp / "one" / "step_1"))["model"]
    many = ckpt.restore_state(str(tmp / name / "step_1"))["model"]
    if name == "pp":
        assert ppl.is_pipelined_params(many) and ckpt.is_sharded_checkpoint(str(tmp / name / "step_1"))
        many = ppl.merge_pipelined_params(many)
    from tchvp_tpu_torch import config

    args = cli._build_parser()[0].parse_args(["video", *SP_ARGV, "--attn-impl", "flash"])
    real = config.flagship_video_config
    config.flagship_video_config = torch_dist.flagship_without_dropout
    try:
        init = cli._video_model(args, "cpu").state_dict()
    finally:
        config.flagship_video_config = real
    _held_to_one(many, one, init)


def test_segment_spatial_ring_two_ranks_match_one_process(mesh_runs):
    """``segment --mesh spatial=2 --attn-impl ring``: FCT's rows in halves,
    its attention on the ring over them, dropout drawn for the whole maps;
    its checkpoint equals one process's with the dense core (no BatchNorm:
    within 1e-4 of the largest update)."""
    _segment_held_to_one(mesh_runs, 1, "seg_sp", {"sp_constrain_conv", "sp_halo", "ring_shard_map"})


def test_segment_spatial_gathered_two_ranks_match_one_process(mesh_runs):
    """``segment --mesh spatial=2 --attn-impl xla``: FCT's rows in halves,
    its attention on the tokens gathered over the axis (every parameter's
    gradient summed over it); its checkpoint equals one process's."""
    _segment_held_to_one(mesh_runs, 4, "seg_sp_xla", {"sp_constrain_conv", "sp_halo", "seq_gathered"})


def _segment_held_to_one(mesh_runs, index: int, name: str, markers: set) -> None:
    tmp, ranks, one_text = mesh_runs
    for r in ranks:
        assert markers <= r["runs"][index]["seen"], sorted(r["runs"][index]["seen"])
        assert "Epoch 1: dice loss" in r["runs"][index]["printed"]
    one = ckpt.restore_state(str(tmp / "seg_one" / "step_1"))["model"]
    many = ckpt.restore_state(str(tmp / name / "step_1"))["model"]
    init = cli._fct_model("cpu").state_dict()
    scale = max((init[k] - one[k]).abs().max().item() for k in one)
    for k in one:
        torch.testing.assert_close(many[k], one[k], atol=1e-4 * scale, rtol=0, msg=k)
    loss = lambda t: re.search(r"dice loss ([0-9.]+)", t).group(1)  # noqa: E731
    assert loss(ranks[0]["runs"][index]["printed"]) == loss(one_text["segment"])


def test_stream_data_parallel_two_ranks_count_one_process_frames(mesh_runs):
    """``stream --data-parallel`` as two ranks: each streams its clip of
    every batch of 2 and prints the global frame count, one process's."""
    _, ranks, one = mesh_runs
    frames = lambda t: re.search(r"streamed (\d+) frames @ 32x32", t).group(1)  # noqa: E731
    assert frames(one["stream"]) == "4"
    for r in ranks:
        assert frames(r["runs"][5]["printed"]) == frames(one["stream"])
        assert r["runs"][5]["seen"] == {"sdpa_xla"}


def test_infer_pipe_int8_two_ranks_match_one_process(mesh_runs):
    """``infer --mesh pipe=2 --int8`` (conv-only int8; the temporal stack
    pipelined in bf16) prints one process's PSNR on its own checkpoint."""
    _, ranks, one = mesh_runs
    psnr = lambda t: re.search(r"mean PSNR ([0-9.]+) dB", t).group(1)  # noqa: E731
    assert "int8: 35 layers quantized" in ranks[0]["runs"][3]["printed"]
    assert "pipeline_shard_map" in ranks[0]["runs"][3]["seen"]
    # The two runs' checkpoints differ (two ranks against one process, at
    # the step's rounding), so the PSNRs agree to a hundredth of a dB.
    assert abs(float(psnr(ranks[0]["runs"][3]["printed"])) - float(psnr(one["infer"]))) <= 0.02
