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
    assert set(targs) == set(jargs) - {"tp_axis", "ep_axis", "sp_axis"} | {"device"}
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
# item None: ported since (the conv families, item 7; serving, item 10): the
# command runs, or exits with a message of its own, and is not refused.
STREAM_SMALL = ["--tile", "32", "--height", "32", "--width", "32", "--chunk-len", "2", "--ctx-frames", "1"]
UNPORTED = [
    (["denoise"], None), (["transfer"], None), (["port"], None),
    (["export"], None), (["serve"], None), (["shards"], 11), (["tune"], 12),
    (["video", "--model", "ae32k"], None), (["video", "--fsdp"], 11), (["video", "--qat"], None),
    (["video", "--num-experts", "2"], 11), (["video", "--mesh", "data=2"], 11),
    (["video", "--data-parallel"], 11), (["video", "--attn-impl", "ring"], 11),
    (["eval", "--model", "unet"], None), (["eval", "--int8"], None),
    (["infer", "--exported", "a.tchvp"], None), (["infer", "--url", "http://localhost:1"], None),
    (["infer", "--int8"], None), (["infer", "--mesh", "pipe=2"], 11),
    (["stream", "--int8", *STREAM_SMALL], None), (["stream", "--url", "http://localhost:1"], None),
    (["summary", "--model", "unet"], None), (["summary", "--model", "ae32k"], None),
    (["export", "--out", "m.tchvp", "--int8", *MODEL_ARGS], None),
    (["serve", "--port", "8765", "--buckets", "1,2"], None),
    (["serve", "--exported", "m.tchvp", "--data-parallel"], 11),
    (["serve", "--exported", "m.tchvp", "--mesh", "pipe=2"], 11),
    (["tune", "--shape", "8x8x2048x64", "--mode", "fwd"], 12),
    (["segment", "--mesh", "data=2", "--attn-impl", "flash"], 11),
    (["segment", "--mesh", "spatial=2"], 11), (["segment", "--attn-impl", "ring"], 11),
    (["segment", "--data-parallel"], 11), (["denoise", "--data-parallel"], 11),
    (["transfer", "--data-parallel"], 11),
    (["video", "--moe-aux-weight", "0.02"], 11), (["video", "--router-top-k", "2"], 11),
    (["infer", "--router-top-k", "2"], 11), (["eval", "--num-experts", "4"], 11),
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
