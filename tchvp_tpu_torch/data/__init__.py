"""Data layer: CSV manifests, the packed-clip native loader, synthetic
generators, device prefetch, and preprocessing and augmentation on the
card. Exports what ``tchvp_tpu/data/__init__.py`` exports."""

from tchvp_tpu_torch.data.clippack import (
    ClipPackDataset,
    pack_clips,
    pack_from_manifest,
)
from tchvp_tpu_torch.data.manifest import (
    ClipDataset,
    ImageDataset,
    ImageMaskDataset,
    make_loaders,
    read_manifest,
    write_clip_manifest,
    write_manifest,
)
from tchvp_tpu_torch.data.synthetic import SyntheticClips, SyntheticImageMasks, SyntheticImages
from tchvp_tpu_torch.data import pipeline

__all__ = [
    "ClipPackDataset",
    "pack_clips",
    "pack_from_manifest",
    "ClipDataset",
    "ImageDataset",
    "ImageMaskDataset",
    "make_loaders",
    "read_manifest",
    "write_manifest",
    "write_clip_manifest",
    "SyntheticClips",
    "SyntheticImageMasks",
    "SyntheticImages",
    "pipeline",
]
