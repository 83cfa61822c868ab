"""Build the package's CUDA sources into shared libraries at first use.

Each library is compiled by ``nvcc`` in a subprocess into
``tchvp_tpu_torch/_build/<name>-<hash>/`` (listed in ``.gitignore``), where
the hash covers the sources, the shared headers (``csrc/*.cuh``) and the
flags, and is bound through ``ctypes`` to a plain ``extern "C"`` launcher.
This needs neither ``ninja`` nor PyTorch's headers, so a build takes
seconds; :func:`load_all` runs one ``nvcc`` per library, all at once. A
missing ``nvcc`` or a failed build raises: nothing falls back to a plain
version.
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


def load(name: str, sources: Sequence[str]) -> ctypes.CDLL:
    """Compile ``csrc/<sources>`` into ``lib<name>.so`` (once per content
    hash) and return the loaded library."""
    with _locks_guard:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if name in _libs:
            return _libs[name]
        paths = [CSRC / s for s in sources]
        digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for p in paths + sorted(CSRC.glob("*.cuh")):
            digest.update(p.read_bytes())
        out_dir = BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}"
        lib_path = out_dir / f"lib{name}.so"
        log_path = out_dir / "build.log"
        t0 = time.perf_counter()
        if not lib_path.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            tmp = out_dir / f"lib{name}.{os.getpid()}.tmp.so"
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), *map(str, paths)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed building {name} (exit {proc.returncode}):\n{log}")
            log_path.write_text(log)
            os.replace(tmp, lib_path)
        build_seconds[name] = time.perf_counter() - t0
        build_log[name] = log_path.read_text() if log_path.exists() else ""
        _libs[name] = ctypes.CDLL(str(lib_path))
        return _libs[name]


def load_all(libraries: Mapping[str, Sequence[str]]) -> Dict[str, ctypes.CDLL]:
    """:func:`load` every ``{name: sources}`` at once, one ``nvcc`` each."""
    with ThreadPoolExecutor(max_workers=len(libraries)) as pool:
        futures = {name: pool.submit(load, name, srcs) for name, srcs in libraries.items()}
        return {name: f.result() for name, f in futures.items()}
