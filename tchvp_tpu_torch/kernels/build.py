"""Build the package's CUDA sources (and the host C++ of the clip loader)
into shared libraries at first use.

Each CUDA library is compiled by ``nvcc`` in a subprocess into
``tchvp_tpu_torch/_build/<name>-<hash>/`` (listed in ``.gitignore``), where
the hash covers the sources, the shared headers (``csrc/*.cuh``) and the
flags, and is bound through ``ctypes`` to a plain ``extern "C"`` launcher.
This needs neither ``ninja`` nor PyTorch's headers, so a build takes
seconds; :func:`load_all` runs one ``nvcc`` per library, all at once. A
library of the attention kernels (``UNIT_BLOCKS``) is compiled as one
translation unit per block candidate of its list, all at once, then
linked: each unit is given a header (:func:`unit_header`) that defines the
candidate lists and the unit's share of them, from which the sources
instantiate their kernels.
:func:`load_host` builds a C++ file with ``g++`` into the same hashed
directories. A missing compiler or a failed build raises: nothing falls
back to a plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Mapping, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# The kernel libraries of the port, {name: sources under csrc/}.
LIBRARIES = {"flash_fwd": ["flash_fwd.cu"], "flash_bwd": ["flash_bwd.cu"],
             "band_attention": ["band_attention.cu"], "halo_attention": ["halo_attention.cu"],
             "fused_tail": ["fused_tail.cu"]}
# The block candidates of the attention kernels: (block_q, block_k) of the
# flash kernels and block_rows of the banded and halo kernels, the first of
# each the default. The sources instantiate exactly these (unit_header).
FLASH_BLOCKS = ((64, 64), (128, 64), (64, 32), (128, 32))
WIN_BLOCKS = (64, 128)
# Libraries built in parts, one translation unit per candidate of their
# list, so that the build's wall time stays that of one candidate's kernels.
UNIT_BLOCKS = {"flash_fwd": FLASH_BLOCKS, "flash_bwd": FLASH_BLOCKS,
               "band_attention": WIN_BLOCKS, "halo_attention": WIN_BLOCKS}
HOST_CXX = "g++"
HOST_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_libs: Dict[str, ctypes.CDLL] = {}
_locks: Dict[str, threading.Lock] = {}
_locks_guard = threading.Lock()
# Seconds each library took to build in this process (0.0 when it came
# from the cache directory), and the compiler's resource report.
build_seconds: Dict[str, float] = {}
build_log: Dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME or /usr/local/cuda): cannot build the CUDA kernels")


def _macro(name: str, blocks) -> str:
    items = " ".join(f"X({', '.join(map(str, b)) if isinstance(b, tuple) else b})" for b in blocks)
    return f"#define {name}(X) {items}\n"


def unit_header(blocks: Sequence, unit: int) -> str:
    """The header that translation unit ``unit`` of a library over
    ``blocks`` is compiled with: the candidate lists
    (``TCHVP_FLASH_BLOCKS``, ``TCHVP_WIN_BLOCKS``), the candidate the unit
    instantiates (``TCHVP_UNIT_BLOCKS``), and in unit 0, which also holds
    the C launchers, the others', declared extern
    (``TCHVP_EXTERN_BLOCKS``)."""
    return (f"#define TCHVP_UNIT {unit}\n" + _macro("TCHVP_FLASH_BLOCKS", FLASH_BLOCKS)
            + _macro("TCHVP_WIN_BLOCKS", WIN_BLOCKS) + _macro("TCHVP_UNIT_BLOCKS", [blocks[unit]])
            + _macro("TCHVP_EXTERN_BLOCKS", blocks[1:] if unit == 0 else []))


def _load(name: str, compiler, flags: Sequence[str], sources: Sequence[Path],
          hashed: Sequence[Path]) -> ctypes.CDLL:
    """Compile ``sources`` into ``lib<name>.so`` under a directory named by
    the hash of ``hashed`` and ``flags`` (once per hash; the library is
    moved into place atomically, so concurrent processes never load a
    half-written one) and return the loaded library. ``compiler()`` gives
    the compiler's path and is called only when a build is needed."""
    with _locks_guard:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if name in _libs:
            return _libs[name]
        blocks = UNIT_BLOCKS.get(name) if compiler is nvcc_path else None
        headers = [unit_header(blocks, i) for i in range(len(blocks))] if blocks else []
        digest = hashlib.sha256(" ".join(flags).encode() + "".join(headers).encode())
        for p in hashed:
            digest.update(p.read_bytes())
        out_dir = BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}"
        lib_path = out_dir / f"lib{name}.so"
        log_path = out_dir / "build.log"
        t0 = time.perf_counter()
        if not lib_path.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            tmp = out_dir / f"lib{name}.{os.getpid()}.tmp.so"
            exe = compiler()
            if not headers:
                log = _run([exe, *flags, "-o", str(tmp), *map(str, sources)], name)
            else:
                units = range(len(headers))
                objs = [out_dir / f"{name}.{i}.{os.getpid()}.o" for i in units]
                for i in units:
                    (out_dir / f"unit{i}.h").write_text(headers[i])
                compile_flags = [f for f in flags if f != "-shared"]
                with ThreadPoolExecutor(max_workers=len(headers)) as pool:
                    logs = list(pool.map(lambda i: _run(
                        [exe, *compile_flags, "-c", "-include", str(out_dir / f"unit{i}.h"),
                         "-o", str(objs[i]), *map(str, sources)], f"{name} unit {i}"), units))
                logs.append(_run([exe, *flags, "-o", str(tmp), *map(str, objs)], f"{name} (link)"))
                log = "".join(logs)
                for o in objs:
                    o.unlink()
            log_path.write_text(log)
            os.replace(tmp, lib_path)
        build_seconds[name] = time.perf_counter() - t0
        build_log[name] = log_path.read_text() if log_path.exists() else ""
        _libs[name] = ctypes.CDLL(str(lib_path))
        return _libs[name]


def _run(cmd: Sequence[str], what: str) -> str:
    """Run one compiler command; its output, or a raise with it."""
    try:
        proc = subprocess.run(list(cmd), capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot run {cmd[0]} to build {what}: {e}") from e
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"{cmd[0]} failed building {what} (exit {proc.returncode}):\n{log}")
    return log


def load(name: str, sources: Sequence[str]) -> ctypes.CDLL:
    """Compile ``csrc/<sources>`` into ``lib<name>.so`` with ``nvcc`` (once
    per content hash, every ``csrc/*.cuh`` included) and return the loaded
    library. A loaded library returns before anything touches the disk:
    the kernel wrappers call this on every launch."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    paths = [CSRC / s for s in sources]
    return _load(name, nvcc_path, NVCC_FLAGS, paths, paths + sorted(CSRC.glob("*.cuh")))


def host_compiler_path() -> str:
    found = shutil.which(HOST_CXX)
    if found is None:
        raise RuntimeError(f"{HOST_CXX} not found on PATH: cannot build the host libraries")
    return found


def load_host(name: str, source: Path) -> ctypes.CDLL:
    """Compile the C++ file ``source`` into ``lib<name>.so`` with the host
    compiler (once per content hash) and return the loaded library."""
    return _load(name, host_compiler_path, HOST_FLAGS, [source], [source])


def load_all(libraries: Mapping[str, Sequence[str]]) -> Dict[str, ctypes.CDLL]:
    """:func:`load` every ``{name: sources}`` at once, one ``nvcc`` each."""
    with ThreadPoolExecutor(max_workers=len(libraries)) as pool:
        futures = {name: pool.submit(load, name, srcs) for name, srcs in libraries.items()}
        return {name: f.result() for name, f in futures.items()}
