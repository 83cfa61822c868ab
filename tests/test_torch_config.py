"""The port's config dataclasses equal the JAX package's, field for field."""

import dataclasses
import inspect

import pytest

from tchvp_tpu import config as jcfg
from tchvp_tpu_torch import config as tcfg


def _defaults(cls):
    out = {}
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING:
            out[f.name] = f.default
        elif f.default_factory is not dataclasses.MISSING:
            out[f.name] = dataclasses.asdict(f.default_factory())
        else:
            out[f.name] = dataclasses.MISSING
    return out


@pytest.mark.parametrize("name", ["AutoEncoderConfig", "UNetConfig", "ResNetAEConfig",
                                  "TransformerConfig", "VideoModelConfig", "AugmentConfig",
                                  "TrainConfig", "DataConfig", "IngestConfig"])
def test_dataclass_fields_and_defaults_match(name):
    jc, tc = getattr(jcfg, name), getattr(tcfg, name)
    assert [f.name for f in dataclasses.fields(tc)] == [f.name for f in dataclasses.fields(jc)]
    assert _defaults(tc) == _defaults(jc)
    assert tc.__dataclass_params__.frozen == jc.__dataclass_params__.frozen


def test_notebook_variant_matches():
    assert tcfg.AutoEncoderConfig.notebook_variant() == tcfg.AutoEncoderConfig(
        **dataclasses.asdict(jcfg.AutoEncoderConfig.notebook_variant()))


def test_flagship_video_config_signature_matches():
    js = inspect.signature(jcfg.flagship_video_config)
    ts = inspect.signature(tcfg.flagship_video_config)
    assert [(p.name, p.default) for p in ts.parameters.values()] == [
        (p.name, p.default) for p in js.parameters.values()
    ]


@pytest.mark.parametrize("kwargs", [
    {},
    {"image_size": 32, "num_heads": 8, "hidden_dim": 32, "attn_impl": "flash"},
    {"image_size": 384, "num_layers": 3, "window_size": 64},
])
def test_flagship_video_config_builds_equal_configs(kwargs):
    assert dataclasses.asdict(tcfg.flagship_video_config(**kwargs)) == dataclasses.asdict(
        jcfg.flagship_video_config(**kwargs)
    )


def test_flagship_video_config_rejects_indivisible_heads():
    with pytest.raises(ValueError, match="not divisible"):
        tcfg.flagship_video_config(image_size=36, num_heads=7)
