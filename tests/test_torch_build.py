"""``kernels/build.py``: a library already loaded is returned without
touching the disk. The band, halo and backward wrappers call
``build.load`` on every launch, and a directory scan of ``csrc/`` per call
cost 0.25-0.5 ms of host time per launch on the card machine, several
times the kernels' own time."""

from pathlib import Path

import pytest

from tchvp_tpu_torch.kernels import build


def test_loaded_library_returns_without_touching_the_disk(monkeypatch):
    lib = object()
    monkeypatch.setitem(build._libs, "band_attention", lib)

    def no_disk(*a, **k):
        raise AssertionError("build.load touched the disk for a loaded library")

    for name in ("glob", "read_bytes"):
        monkeypatch.setattr(Path, name, no_disk)
    assert build.load("band_attention", ["band_attention.cu"]) is lib


def test_a_missing_library_still_goes_to_the_build(monkeypatch):
    monkeypatch.delitem(build._libs, "band_attention", raising=False)
    calls = []
    monkeypatch.setattr(build, "_load", lambda name, compiler, flags, sources, hashed: calls.append(
        (name, [p.name for p in sources], sorted(p.name for p in hashed))) or "lib")
    assert build.load("band_attention", ["band_attention.cu"]) == "lib"
    (name, sources, hashed), = calls
    assert name == "band_attention" and sources == ["band_attention.cu"]
    assert "band_attention.cu" in hashed and "flash_common.cuh" in hashed


def test_library_table_names_every_source():
    for name, sources in build.LIBRARIES.items():
        assert sources == [f"{name}.cu"] and (build.CSRC / sources[0]).is_file(), name


if __name__ == "__main__":  # pragma: no cover
    pytest.main([__file__])
