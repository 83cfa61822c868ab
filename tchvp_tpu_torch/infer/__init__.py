"""Serving: int8 post-training quantization (``quant``), ``torch.export``
artifacts (``export``) and the HTTP server (``server``); counterpart of
``tchvp_tpu/infer``."""

from tchvp_tpu_torch.infer.server import ArtifactServer, post_npy, serve_artifact
from tchvp_tpu_torch.infer.export import (
    ServingModel,
    export_int8_video_model,
    export_serving,
    export_video_model,
    load_artifact,
    save_artifact,
)
from tchvp_tpu_torch.infer.quant import (
    Int8Engine,
    calibrate_conv_scales,
    quantize_conv_params,
)

__all__ = [
    "ArtifactServer",
    "post_npy",
    "serve_artifact",
    "Int8Engine",
    "ServingModel",
    "calibrate_conv_scales",
    "export_int8_video_model",
    "export_serving",
    "export_video_model",
    "load_artifact",
    "quantize_conv_params",
    "save_artifact",
]
