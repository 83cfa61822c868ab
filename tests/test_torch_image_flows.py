"""The port's image flows and the commands of the conv families, on the CPU
at small sizes, through ``cli.main`` with ``--device cpu``: ``denoise``
(``DenoisingFlow``: the best-val weights file, the ``save_every`` state and
its inpainting sample), ``port --model ae32k`` then ``transfer
--pretrained`` (``TransferFlow``: the frozen encoder, sneak peeks, resume,
``test_a_sample``), ``video --model ae4k`` with ``eval``, ``infer`` and
``stream`` on its checkpoint, ``eval --model ae|unet|combined|ae32k|ae4k``
and ``summary`` for every family.

Against the JAX package: the video train step of the frame AE
(``FrameAE(Autoencoder32K)``, dropout 0, MSE, no noise, SGD lr 1, whose
update -1.9 g gives the gradients back): loss and PSNR rtol 1e-5, the
BatchNorm stats within 1e-4 x the largest, and the gradients no farther
from the port's float64 gradients of the same loss than 10x JAX's fp32 ones
(``tests/test_torch_conv_families.py``'s rule for the ResNet AEs, whose
train-mode BatchNorm chains put JAX's own fp32 gradients ~2 % of the
largest from float64); the printed dice, IoU (and, for
the combined model, PSNR) of ``eval --model unet|combined`` on a checkpoint
of seeded weights against the same metrics of JAX's model on the same
batches (4 printed decimals: within 1e-4); ``summary``'s parameter counts
against the JAX models' (``jax.eval_shape``). Port only: with dropout on,
the remat policies give the frame AE the gradients and stats of ``"none"``
(atol 1e-6), as they do in JAX.
"""

import contextlib
import io
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tchvp_tpu import cli as jcli
from tchvp_tpu import config as jcfg
from tchvp_tpu import losses as jlosses
from tchvp_tpu.data import pipeline as jpipe
from tchvp_tpu.models import combined as jcomb
from tchvp_tpu.models import resnet_ae as jres
from tchvp_tpu.models import unet as junet
from tchvp_tpu.train import state as jstate
from tchvp_tpu.train import steps as jsteps
from tchvp_tpu_torch import cli, convert
from tchvp_tpu_torch import config as tcfg
from tchvp_tpu_torch import losses as tlosses
from tchvp_tpu_torch.data import pipeline as tpipe
from tchvp_tpu_torch.data.synthetic import SyntheticImageMasks
from tchvp_tpu_torch.models import combined as tcomb
from tchvp_tpu_torch.models import resnet_ae as tres
from tchvp_tpu_torch.models import unet as tunet
from tchvp_tpu_torch.models.frame_ae import FrameAE
from tchvp_tpu_torch.train import checkpoint as ckpt
from tchvp_tpu_torch.train import state as tstate
from tchvp_tpu_torch.train import steps as tsteps
from tchvp_tpu_torch.train.loops import TransferFlow
from test_torch_conv_families import flax_variables
from test_torch_reference_import import RefWriter, ref_resnet
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

CPU = ["--device", "cpu", "--batch-size", "2"]


def _run(argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(argv)
    return out.getvalue()


def _count(tree) -> int:
    return sum(int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(tree))


# ---------------------------------------------------------------- denoise


def test_denoise_writes_best_val_weights_state_and_test_sample(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    text = _run(["denoise", "--synthetic", "2", "--epochs", "5", "--image-size", "32", "--loss", "mse",
                 *CPU])
    lines = text.splitlines()
    assert re.fullmatch(r"Total parameters: 518\.39K", lines[0]), lines[0]
    epochs = [re.fullmatch(r"Epoch (\d): loss [0-9.]+ train PSNR [0-9.]+ val PSNR ([0-9.]+) \([0-9.]+s\)", ln)
              for ln in lines[1:]]
    assert [int(m.group(1)) for m in epochs] == [1, 2, 3, 4, 5]
    assert sorted(os.listdir("checkpoints")) == ["IMAGE2IMAGE", "run.json", "step_5"]
    best = ckpt.restore_state("checkpoints/IMAGE2IMAGE")
    assert "step" not in best and set(best) == {"format", "model"}
    state = ckpt.restore_state("checkpoints/step_5")
    assert state["step"] == 5 and state["train_step"] == 10
    assert abs(state["extra"]["best_val_psnr"] - max(float(m.group(2)) for m in epochs)) <= 5e-3  # 2 decimals
    assert os.listdir("saved_samples/IMAGE2IMAGE") == ["5.jpg"]
    assert list((tmp_path / "runs" / "IMAGE2IMAGE").glob("events.out.tfevents.*"))
    for path in ("checkpoints/IMAGE2IMAGE", "checkpoints/step_5"):
        text = _run(["eval", "--model", "ae", "--synthetic", "1", "--image-size", "32", "--checkpoint",
                     path, *CPU])
        assert re.fullmatch(rf"eval ae: reconstruction PSNR [0-9.]+ dB  \[ckpt {path}\]\n", text), text


# ---------------------------------------------------------------- port + transfer


@pytest.fixture(scope="module")
def pretrained(tmp_path_factory):
    """A reference AE_32K state_dict of seeded weights, ported."""
    base = tmp_path_factory.mktemp("transfer")
    v = flax_variables(jres.Autoencoder32K(), np.zeros((1, 32, 32, 3), np.float32), seed=40, train=False)
    w = RefWriter(seed=41)
    ref_resnet(v, w)
    torch.save({k: torch.from_numpy(np.ascontiguousarray(a)) for k, a in w.sd.items()}, base / "AE_32K.pth")
    text = _run(["port", "--model", "ae32k", "--checkpoint", str(base / "AE_32K.pth"),
                 "--out", str(base / "ported")])
    assert text.startswith("ported ae32k: ")
    return str(base / "ported" / "step_0"), convert.from_flax(v)


def test_transfer_keeps_the_pretrained_encoder_frozen(tmp_path, monkeypatch, pretrained):
    path, want = pretrained
    monkeypatch.chdir(tmp_path)
    text = _run(["transfer", "--synthetic", "2", "--epochs", "2", "--image-size", "32", "--pretrained",
                 path, "--lr", "1e-3", *CPU])
    assert re.fullmatch(r"Transfer epoch 1: dice [0-9.]+\nTransfer epoch 2: dice [0-9.]+\n", text), text
    tags = sorted(d for d in os.listdir("checkpoints") if d.startswith("step_"))
    assert tags[0] == "step_1" and set(tags) <= {"step_1", "step_2"}
    raw = ckpt.restore_state(f"checkpoints/{tags[-1]}")["model"]
    params = {k for k in want if k.startswith("encoder.") and "running" not in k
              and "num_batches" not in k}
    assert params and all(torch.equal(raw[k], want[k]) for k in params)
    stats = [k for k in raw if k.startswith("encoder.") and k.endswith("running_var")]
    assert all(not torch.equal(raw[k], torch.ones_like(raw[k])) for k in stats)  # moved from (0, 1)
    decoder = [k for k in raw if k.startswith("decoder.") and k.endswith("weight")]
    assert all(raw["decoder.head_conv.weight"].shape[0] == 1 for _ in decoder)  # the mask head
    peeks = sorted(os.listdir("saved_samples/latent_to_mask"))
    assert peeks == [f"{e}_{n}.jpg" for e in (1, 2) for n in ("actual", "input", "predicted")]


def test_transfer_flow_resumes_and_previews(tmp_path, pretrained):
    path, want = pretrained
    data = SyntheticImageMasks(2, 32, 2, seed=0)
    cfg = tcfg.TrainConfig(model_name="latent_to_mask", loss="dice", checkpoint_dir=str(tmp_path / "ck"),
                           sample_dir=str(tmp_path / "samples"), log_dir=str(tmp_path / "runs"))
    flow = TransferFlow(cfg=cfg, image_size=32, device="cpu")
    flow.init_from_pretrained(path, lr=1e-3)
    assert flow.resume() == 0
    flow.train(data, epochs=1)
    resumed = TransferFlow(cfg=cfg, image_size=32, device="cpu")
    resumed.init_from_pretrained(path, lr=1e-3)
    start = resumed.resume()
    assert start == 1 and resumed.state.step == 2
    live, back = flow.state.model.state_dict(), resumed.state.model.state_dict()
    assert all(torch.equal(live[k], back[k]) for k in live)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        resumed.train(data, epochs=2, start_epoch=start)
    assert re.fullmatch(r"Transfer epoch 2: dice [0-9.]+\n", out.getvalue())
    assert all(torch.equal(resumed.state.model.state_dict()[k], want[k])
               for k in want if k.startswith("encoder.") and "running" not in k and "num_batches" not in k)
    masks = resumed.test_a_sample(data, batch_size=2, out_dir=str(tmp_path / "preview"))
    assert masks.shape == (2, 32, 32, 1) and masks.min() >= 0 and masks.max() <= 1
    assert sorted(os.listdir(tmp_path / "preview")) == ["sample_0.jpg", "sample_1.jpg"]


def test_transfer_without_pretrained_weights_and_refusals():
    flow = TransferFlow(image_size=32, device="cpu")
    state = flow.init_from_pretrained(None)
    assert all(not p.requires_grad for p in flow.model.encoder.parameters())
    assert {id(p) for p in state.tx.trainable} == {id(p) for p in flow.model.decoder.parameters()}
    with pytest.raises(NotImplementedError, match="item 11"):
        TransferFlow(mesh=object(), device="cpu")


# ---------------------------------------------------------------- frame AEs


SIZE = 32


def _frame_ae_variables():
    jmodel = jres.Autoencoder32K(jcfg.ResNetAEConfig(dropout_rate=0.0))
    return jmodel, flax_variables(jmodel, np.zeros((1, SIZE, SIZE, 3), np.float32), seed=50, train=False)


def _clip(seed):
    return np.random.default_rng(seed).integers(0, 256, (2, 2, SIZE, SIZE, 3), dtype=np.uint8)


def test_frame_ae_video_step_matches_jax():
    """JAX's FrameAE is the module ``cli._video_model`` builds, its AE
    swapped for one with dropout 0."""
    jae_, variables = _frame_ae_variables()
    frame = _jax_frame_ae(jae_)
    jvars = {c: {"ae": variables[c]} for c in variables}
    jst = jstate.TrainState.create(apply_fn=frame.apply, params=jax.tree.map(jnp.asarray, jvars["params"]),
                                   tx=jstate.make_optimizer(1.0, optimizer="sgd"),
                                   batch_stats=jax.tree.map(jnp.asarray, jvars["batch_stats"]),
                                   rng=jax.random.PRNGKey(1))
    jnew, jm = jsteps.make_video_train_step(SIZE, loss="mse", noise_std=0.0)(jst, jnp.asarray(_clip(3)))
    want = {f"ae.{k}": v for k, v in convert.from_flax(
        {c: jax.tree.map(np.asarray, getattr(jnew, c))["ae"] for c in ("params", "batch_stats")}).items()}

    def port_model():
        model = FrameAE(tres.Autoencoder32K(tcfg.ResNetAEConfig(dropout_rate=0.0), device="cpu"))
        model.ae.load_state_dict(convert.from_flax(variables), strict=True)
        return model

    model = port_model()
    state = tstate.create_train_state(model, tstate.make_optimizer(1.0, optimizer="sgd"))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state, m = tsteps.make_video_train_step(SIZE, loss="mse", noise_std=0.0)(state, torch.from_numpy(_clip(3)))
    for k in ("loss", "psnr"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    after = model.state_dict()
    stats = [k for k in after if "running" in k]
    top = max(float(want[k].abs().max()) for k in stats)
    assert max(float((after[k] - want[k]).abs().max()) for k in stats) <= 1e-4 * top
    # The float64 gradients of the step's loss: the port's model in float64.
    ref = port_model().double().train()
    clip = tpipe.preprocess_clip(torch.from_numpy(_clip(3)), SIZE).double()
    tlosses.mse(ref(clip)[1], clip).backward()
    g64 = {n: p.grad for n, p in ref.named_parameters()}
    params = list(g64)
    top = max(float(g.abs().max()) for g in g64.values())

    def dist(new):  # SGD lr 1, Nesterov 0.9: p1 = p0 - 1.9 g
        return max(float(((before[k] - new[k]).double() / 1.9 - g64[k]).abs().max()) for k in params) / top

    assert dist(after) <= 10 * dist(want), (dist(after), dist(want))


def _jax_frame_ae(ae):
    """The ``FrameAE`` of JAX's ``cli._video_model`` around ``ae``."""
    args = type("Args", (), {"model": "ae32k", "num_experts": 0, "tp_axis": None, "sp_axis": None})()
    return jcli._video_model(args).clone(ae=ae)


def test_remat_policies_give_the_frame_ae_the_gradients_of_none():
    _, variables = _frame_ae_variables()
    out = {}
    for policy in ("none", "full", "stages", "dots"):
        model = FrameAE(tres.Autoencoder32K(device="cpu"))  # dropout 0.3
        model.ae.load_state_dict(convert.from_flax(variables), strict=True)
        state = tstate.create_train_state(model, tstate.make_optimizer(1e-3), rng=4)
        grads = {}

        def mark(name):
            if name == "backward":
                grads.update({n: p.grad.clone() for n, p in model.named_parameters()})

        tsteps.make_video_train_step(SIZE, loss="mse", remat_policy=policy)(
            state, torch.from_numpy(_clip(5)), mark=mark)
        out[policy] = grads, {k: v for k, v in model.state_dict().items() if "running" in k}
    for policy in ("full", "stages", "dots"):
        for ref, got in zip(out["none"], out[policy]):
            assert all(torch.allclose(got[k], ref[k], atol=1e-6, rtol=0) for k in ref), policy


def test_video_ae4k_then_eval_infer_stream(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    common = ["--image-size", "64", "--clip-len", "2", *CPU]
    text = _run(["video", "--model", "ae4k", "--synthetic", "2", "--epochs", "2", "--save-every", "1",
                 *common])
    assert re.fullmatch(r"Video epoch 1: loss [0-9.]+ PSNR [0-9.]+\nVideo epoch 2: loss [0-9.]+ PSNR [0-9.]+\n",
                        text), text
    raw = ckpt.restore_state("checkpoints/step_2")
    assert raw["model"] and all(k.startswith("ae.") for k in raw["model"])
    assert raw["model"]["ae.decoder.convs.0.weight"].shape[1] == 16  # the 16-channel latent
    text = _run(["eval", "--model", "ae4k", "--synthetic", "1", *common])
    assert re.fullmatch(r"eval ae4k: reconstruction PSNR [0-9.]+ dB  \[ckpt .*step_2\]\n", text), text
    text = _run(["infer", "--model", "ae4k", "--synthetic", "2", "--checkpoint", "checkpoints/step_2",
                 "--out-dir", "frames", *common])
    assert re.fullmatch(r"inferred 2 batches, mean PSNR [0-9.]+ dB, [0-9.]+ frames/s \(post-warm-up\)\n", text)
    assert sorted(os.listdir("frames")) == ["clip0_frame0.jpg", "clip0_frame1.jpg"]
    text = _run(["stream", "--model", "ae4k", "--synthetic", "2", "--checkpoint", "checkpoints/step_2",
                 "--height", "100", "--width", "70", "--tile", "64", "--clip-len", "4", "--chunk-len", "2",
                 "--ctx-frames", "2", "--device", "cpu", "--batch-size", "1"])
    assert re.fullmatch(r"streamed 4 frames @ 100x70: [0-9.]+ frames/s\n", text), text
    with pytest.raises(SystemExit, match="--model hybrid only"):
        _run(["video", "--model", "ae32k", "--num-experts", "2", "--synthetic", "1", *common])


def test_eval_ae32k_on_a_ported_checkpoint(tmp_path, monkeypatch, pretrained):
    """A ``port --model ae32k`` checkpoint has top-level encoder/decoder keys,
    a ``video --model ae32k`` one the FrameAE's ``ae.`` prefix: eval of the
    frame AE reads the latter and refuses the former."""
    path, _ = pretrained
    monkeypatch.chdir(tmp_path)
    common = ["--image-size", "32", "--clip-len", "2", *CPU]
    _run(["video", "--model", "ae32k", "--synthetic", "1", "--epochs", "1", "--save-every", "1", *common])
    text = _run(["eval", "--model", "ae32k", "--synthetic", "1", *common])
    assert re.fullmatch(r"eval ae32k: reconstruction PSNR [0-9.]+ dB  \[ckpt .*step_1\]\n", text), text
    with pytest.raises(RuntimeError, match="ae.encoder"):
        _run(["eval", "--model", "ae32k", "--synthetic", "1", "--checkpoint", path, *common])


# ---------------------------------------------------------------- eval unet / combined


def _printed(text: str) -> dict:
    return {k: float(v) for k, v in re.findall(r"(\w+) ([0-9.]+)(?:,| over)", text)}


@pytest.mark.parametrize("name", ["unet", "combined"])
def test_eval_mask_models_print_jax_metrics(tmp_path, monkeypatch, name):
    """The port's ``eval --model`` on a checkpoint of seeded weights of the
    default model against JAX's model on the same weights and batches."""
    monkeypatch.chdir(tmp_path)
    size = 32
    jmodel = junet.UNet() if name == "unet" else jcomb.Image2Image2Mask()
    variables = flax_variables(jmodel, np.zeros((1, size, size, 3), np.float32), seed=60, train=False)
    model = (tunet.UNet if name == "unet" else tcomb.Image2Image2Mask)(device="cpu")
    model.load_state_dict(convert.from_flax(variables), strict=True)
    path = ckpt.save_state(str(tmp_path / "ck"), 1, model)
    text = _run(["eval", "--model", name, "--synthetic", "2", "--image-size", str(size), "--checkpoint",
                 path, *CPU])
    assert re.fullmatch(rf"eval {name}: .* over 2 batches  \[ckpt {path}\]\n", text), text
    apply = jax.jit(lambda x: jmodel.apply(variables, x, train=False))
    sums = {}
    for image_u8, mask_u8 in SyntheticImageMasks(2, size, 2, 0):
        x, y = (jpipe.preprocess_images(jnp.asarray(t), size) for t in (image_u8, mask_u8))
        out = apply(x)
        mask = out if name == "unet" else out[2]
        m = {"dice": jlosses.dice_loss(mask, y), "iou": jlosses.jaccard_score(mask > 0.5, y > 0.5)}
        if name == "combined":
            m["psnr"] = jlosses.psnr(out[1], x)
        for k, v in m.items():
            sums[k] = sums.get(k, 0.0) + float(v)
    got = _printed(text)
    assert got.keys() == sums.keys()
    for k in sums:
        assert abs(got[k] - sums[k] / 2) <= 1e-4, (k, got[k], sums[k] / 2)


# ---------------------------------------------------------------- summary


@pytest.mark.parametrize("name", ["hybrid", "ae32k", "ae4k", "fct", "unet", "ae", "combined"])
def test_summary_counts_match_jax(name):
    size = 64
    text = _run(["summary", "--model", name, "--image-size", str(size), "--clip-len", "2", "--depth", "1"])
    margs = type("Args", (), {"model": name, "image_size": size, "layers": 2, "num_experts": 0,
                              "router_top_k": 1, "attn_impl": None, "window": 0, "tp_axis": None,
                              "sp_axis": None, "seq_axis": None, "ep_axis": None})()
    jmodel, example, is_clip = jcli._export_model(margs, size)
    if is_clip:
        example = jnp.zeros((1, 2) + example.shape[2:])
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), example))["params"]
    total = int(re.search(r": \S+ parameters \(([0-9,]+)\)", text).group(1).replace(",", ""))
    assert total == _count(shapes), (total, _count(shapes))
    shape = (1, 2, size, size, 3) if is_clip else (1, size, size, 3)
    assert f"Input: {shape} float32" in text
