"""The port's reference-checkpoint importer (``utils/torch_port.py``) and
its ``port`` command against the JAX package's ``torch_port``, without the
executed reference.

For each of the seven ``port --model`` choices a flax tree of the JAX
model's own shapes is filled from a seed (BatchNorm stats away from 0 and
1) and turned into the reference's state_dict by the importer's layout
rules run backwards: conv OIHW, transposed conv (in, out, kh, kw) unflipped,
linear (out, in), the packed ``in_proj`` of ``nn.MultiheadAttention``, and
a seeded bias on every BN-followed conv whose bias the importer folds into
the running mean (the running mean written with the bias added back). The
JAX importer must return that same tree (the folded means within 1e-6, the
rest exactly): that holds the backwards rules. Then the port's copy of the
importer returns the JAX one's tree bit for bit, ``import_reference`` gives
the port's model holding exactly ``convert.from_flax`` of it, and ``port``
through ``cli.main`` writes that state_dict to ``<out>/step_0``, printing
JAX's count of arrays, from a bare state_dict or from a training-state
dict's ``model_state_dict``.
"""

import contextlib
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tchvp_tpu import config as jcfg
from tchvp_tpu.models import autoencoder as jae
from tchvp_tpu.models import fct as jfct
from tchvp_tpu.models import resnet_ae as jres
from tchvp_tpu.models import transformer as jtr
from tchvp_tpu.models import unet as junet
from tchvp_tpu.models import video as jvideo
from tchvp_tpu.utils import torch_port as jport
from tchvp_tpu_torch import cli, convert
from tchvp_tpu_torch.train import checkpoint as ckpt
from tchvp_tpu_torch.utils import torch_port as tport
from test_torch_conv_families import flax_variables
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


class RefWriter:
    """A reference state_dict, written from flax subtrees."""

    def __init__(self, seed: int):
        self.sd = {}
        self.rng = np.random.default_rng(seed)

    def conv(self, name, p, fold=False):
        """``p``: a flax Conv. ``fold``: the reference conv has a bias the
        importer folds into the next BN; returns it."""
        self.sd[f"{name}.weight"] = np.transpose(p["kernel"], (3, 2, 0, 1))
        if "bias" in p:
            self.sd[f"{name}.bias"] = p["bias"]
        if fold:
            bias = self.rng.normal(0, 0.1, p["kernel"].shape[-1]).astype(np.float32)
            self.sd[f"{name}.bias"] = bias
            return bias
        return None

    def upconv(self, name, p):
        self.sd[f"{name}.weight"] = np.transpose(p["kernel"][::-1, ::-1], (2, 3, 0, 1))
        self.sd[f"{name}.bias"] = p["bias"]

    def linear(self, name, p):
        self.sd[f"{name}.weight"] = p["kernel"].T
        self.sd[f"{name}.bias"] = p["bias"]

    def ln(self, name, p):
        self.sd[f"{name}.weight"], self.sd[f"{name}.bias"] = p["scale"], p["bias"]

    def bn(self, name, p, s, folded=None):
        p, s = p["BatchNorm_0"], s["BatchNorm_0"]
        self.sd[f"{name}.weight"], self.sd[f"{name}.bias"] = p["scale"], p["bias"]
        self.sd[f"{name}.running_mean"] = s["mean"] + (0 if folded is None else folded)
        self.sd[f"{name}.running_var"] = s["var"]
        self.sd[f"{name}.num_batches_tracked"] = np.array(7)

    def conv_bn(self, conv, bn, p_conv, p_bn, s_bn):
        self.bn(bn, p_bn, s_bn, folded=self.conv(conv, p_conv, fold=True))


UNET_BLOCKS = [("encoder1", "enc1"), ("encoder2", "enc2"), ("encoder3", "enc3"), ("encoder4", "enc4"),
               ("bottleneck", "bottleneck"), ("decoder4", "dec4"), ("decoder3", "dec3"),
               ("decoder2", "dec2"), ("decoder1", "dec1")]


def ref_unet(v, w: RefWriter):
    p, s = v["params"], v["batch_stats"]
    for fname, pre in UNET_BLOCKS:
        for i in (1, 2):
            w.conv(f"{fname}.{pre}conv{i}", p[fname][f"conv{i}"])
            w.bn(f"{fname}.{pre}norm{i}", p[fname][f"norm{i}"], s[fname][f"norm{i}"])
    for i in (1, 2, 3, 4):
        w.upconv(f"upconv{i}", p[f"upconv{i}"])
    w.conv("conv", p["conv"])


def ref_transformer(p, w: RefWriter):
    n = sum(1 for k in p if k.startswith("attention_"))
    for l_ in range(n):
        for ref, ours in (("query_layer", "q_linear"), ("key_layer", "k_linear"),
                          ("value_layer", "v_linear"), ("output_layer", "out_linear")):
            w.linear(f"attention_layers.{l_}.{ref}", p[f"attention_{l_}"][ours])
        w.linear(f"feedforward_layers.{l_}.0", p[f"ffn1_{l_}"])
        w.linear(f"feedforward_layers.{l_}.2", p[f"ffn2_{l_}"])
        w.ln(f"layer_norm.{l_}", p[f"norm_{l_}"])


def ref_resnet(v, w: RefWriter):
    p, s = v["params"], v["batch_stats"]
    e, es = p["encoder"], s["encoder"]
    w.conv_bn("encoder.conv1", "encoder.bn1", e["stem_conv"], e["stem_bn"], es["stem_bn"])
    for block in (k for k in e if k.startswith("layer")):
        li, j = block[len("layer"):].split("_block")
        t = f"encoder.layer{li}.{j}"
        for n in ("1", "2", "3"):
            w.conv_bn(f"{t}.conv{n}", f"{t}.bn{n}", e[block][f"conv{n}"], e[block][f"bn{n}"], es[block][f"bn{n}"])
        if "downsample_conv" in e[block]:
            w.conv_bn(f"{t}.downsample.0", f"{t}.downsample.1", e[block]["downsample_conv"],
                      e[block]["downsample_bn"], es[block]["downsample_bn"])
    for i in range(sum(1 for k in e if k.endswith("_conv") and k.startswith("squeeze"))):
        w.conv_bn(f"encoder.conv{i + 2}", f"encoder.bn{i + 2}", e[f"squeeze{i}_conv"],
                  e[f"squeeze{i}_bn"], es[f"squeeze{i}_bn"])
    d, ds = p["decoder"], s["decoder"]
    for i in range(4):
        w.conv_bn(f"decoder.conv{i + 1}", f"decoder.bn{i + 1}", d[f"conv{i}"], d[f"bn{i}"], ds[f"bn{i}"])
    for i, (tc, tb) in enumerate((("transConv1", "dbn2"), ("transConv2", "dbn3"))):
        w.upconv(f"decoder.{tc}", d[f"upconv{i}"])
        w.bn(f"decoder.{tb}", d[f"up_bn{i}"], ds[f"up_bn{i}"])
    for i, (cn, bn) in enumerate((("conv5", "bn5"), ("conv6", "bn6"))):
        w.conv_bn(f"decoder.{cn}", f"decoder.{bn}", d[f"post_conv{i}"], d[f"post_bn{i}"], ds[f"post_bn{i}"])
    w.conv("decoder.outputDeterminerConv", d["head_conv"])
    w.bn("decoder.outputDeterminerNorm", d["head_bn"], ds["head_bn"])


def ref_fct(v, w: RefWriter):
    p = v["params"]
    for i in range(1, 10):
        t, b = f"block_{i}", p[f"block_{i}"]
        for n in ("conv1_a", "conv1_b", "conv1", "conv2", "conv3"):
            if n in b:
                w.conv(f"{t}.{n}", b[n])
        tr, ao = b["trans"], b["trans"]["attention_output"]
        pre = f"{t}.trans.attention_output"
        for n in ("q", "k", "v"):
            w.conv(f"{pre}.conv_{n}", ao[f"conv_{n}"])
            w.ln(f"{pre}.layernorm_{n}", ao[f"layernorm_{n}"])
        mha = ao["attention"]
        w.sd[f"{pre}.attention.in_proj_weight"] = np.concatenate(
            [mha[f"{n}_proj"]["kernel"].T for n in ("q", "k", "v")])
        w.sd[f"{pre}.attention.in_proj_bias"] = np.concatenate([mha[f"{n}_proj"]["bias"] for n in ("q", "k", "v")])
        w.linear(f"{pre}.attention.out_proj", mha["out_proj"])
        w.conv(f"{t}.trans.conv1", tr["conv1"])
        w.ln(f"{t}.trans.layernorm", tr["layernorm"])
        for j in (1, 2, 3, 4):
            w.conv(f"{t}.trans.wide_focus.conv{j}", tr["wide_focus"][f"conv{j}"])
    for j in (1, 2, 3):
        w.conv(f"ds.conv{j}", p["ds"][f"conv{j}"])


def ref_autoencoder(v, w: RefWriter):
    p = v["params"]
    for part in ("encoder", "decoder"):
        for block, convs in p[part].items():
            for n, c in convs.items():
                w.conv(f"{part}.{block}.{n}", c)


def _jax_vars(module, *shape, **kw):
    return flax_variables(module, np.zeros(shape, np.float32), seed=31, **kw)


def _build(name):
    """(the flax variables, the reference state_dict(s), JAX's import)."""
    w = RefWriter(seed=5)
    if name == "unet":
        v = _jax_vars(junet.UNet(jcfg.UNetConfig(init_features=4)), 1, 32, 32, 3)
        ref_unet(v, w)
        return v, (w.sd,), jport.import_unet(w.sd)
    if name == "fct":
        v = _jax_vars(jfct.FCT(), 1, 32, 32, 3)
        ref_fct(v, w)
        return v, (w.sd,), jport.import_fct(w.sd)
    if name == "autoencoder":
        v = _jax_vars(jae.AutoEncoder(), 1, 64, 64, 3)
        ref_autoencoder(v, w)
        return v, (w.sd,), jport.import_autoencoder(w.sd)
    if name in ("ae32k", "ae32k_mask", "ae4k"):
        module = (jres.Autoencoder4K() if name == "ae4k" else jres.Autoencoder32K(
            jcfg.ResNetAEConfig(output_type="mask" if name == "ae32k_mask" else "image")))
        v = _jax_vars(module, 1, 64, 64, 3, train=False)
        ref_resnet(v, w)
        importer = jport.import_autoencoder4k if name == "ae4k" else jport.import_autoencoder32k
        return v, (w.sd,), importer(w.sd)
    tcfg = jcfg.TransformerConfig(input_dim=64, hidden_dim=32, num_layers=2, num_heads=8)
    if name == "transformer":
        v = _jax_vars(jtr.TransformerEncoder(tcfg), 1, 4, 64)
        ref_transformer(v["params"], w)
        return v, (w.sd,), jport.import_transformer_encoder(w.sd, jport.num_attention_layers(w.sd))
    assert name == "hybrid"
    v = _jax_vars(jvideo.VideoHybridNet(jcfg.flagship_video_config(32, hidden_dim=32)), 1, 2, 32, 32, 3)
    ref_resnet(v, w)
    temporal = RefWriter(seed=6)
    ref_transformer(v["params"]["temporal"], temporal)
    return v, (w.sd, temporal.sd), jport.import_video_hybrid(
        w.sd, temporal.sd, num_layers=jport.num_attention_layers(temporal.sd))


NAMES = ["unet", "fct", "autoencoder", "ae32k", "ae32k_mask", "ae4k", "transformer", "hybrid"]


def _choice(name):
    return "ae32k" if name == "ae32k_mask" else name


def _leaves(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(x) for p, x in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module", params=NAMES)
def built(request):
    return request.param, _build(request.param)


def test_jax_importer_inverts_the_reference_layout(built):
    _, (v, _, imported) = built
    want, got = _leaves(v), _leaves(imported)
    assert got.keys() == want.keys()
    for k in want:
        if "mean" in k:
            np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_port_importer_is_the_jax_importer(built):
    name, (_, sds, imported) = built
    fn = {"unet": tport.import_unet, "fct": tport.import_fct, "autoencoder": tport.import_autoencoder,
          "ae32k": tport.import_autoencoder32k, "ae4k": tport.import_autoencoder4k}
    choice = _choice(name)
    if choice == "transformer":
        got = tport.import_transformer_encoder(sds[0], tport.num_attention_layers(sds[0]))
    elif choice == "hybrid":
        got = tport.import_video_hybrid(*sds, num_layers=tport.num_attention_layers(sds[1]))
    else:
        got = fn[choice](sds[0])
    want, got = _leaves(imported), _leaves(got)
    assert got.keys() == want.keys()
    assert all(np.array_equal(got[k], want[k]) for k in want)


def _want_state(name, imported) -> dict:
    if _choice(name) == "transformer":
        sd = convert.from_flax({"params": {"temporal": imported["params"]}})
        return {k[len("temporal."):]: v for k, v in sd.items()}
    return convert.from_flax(imported)


def test_import_reference_holds_the_converted_jax_import(built):
    name, (_, sds, imported) = built
    model, variables = tport.import_reference(_choice(name), *sds)
    want = _want_state(name, imported)
    got = model.state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    if name.startswith("ae32k"):
        assert model.config.output_type == ("mask" if name == "ae32k_mask" else "image")


def _save(sd, path, wrap=False):
    tensors = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
    torch.save({"epoch": 3, "model_state_dict": tensors} if wrap else tensors, path)
    return str(path)


def test_port_command_writes_the_converted_checkpoint(built, tmp_path):
    name, (_, sds, imported) = built
    files = [_save(sd, tmp_path / f"ref{i}.pth", wrap=i == 0 and name in ("fct", "ae32k"))
             for i, sd in enumerate(sds)]
    argv = ["port", "--model", _choice(name), "--checkpoint", files[0], "--out", str(tmp_path / "out")]
    if name == "hybrid":
        argv += ["--temporal-checkpoint", files[1]]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(argv)
    path = str(tmp_path / "out" / "step_0")
    n = len(jax.tree.leaves(imported))
    assert out.getvalue() == f"ported {_choice(name)}: {n} arrays -> {path}\n"
    raw = ckpt.restore_state(path)
    want = _want_state(name, imported)
    assert raw["step"] == 0 and raw["model"].keys() == want.keys()
    assert all(torch.equal(raw["model"][k], want[k]) for k in want)


def test_port_refusals(tmp_path):
    with pytest.raises(SystemExit, match="--checkpoint"):
        cli.main(["port", "--model", "unet"])
    with pytest.raises(SystemExit, match="--temporal-checkpoint"):
        cli.main(["port", "--model", "hybrid", "--checkpoint", "x.pth", "--out", str(tmp_path)])
    with pytest.raises(ValueError, match="unknown model"):
        tport.import_reference("resnet", {})
    assert not os.listdir(tmp_path)
