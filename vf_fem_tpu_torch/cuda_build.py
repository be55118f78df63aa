"""
Build and load the port's CUDA sources (``csrc/*.cu``) as plain shared
libraries.

Each source is compiled once with ``nvcc`` for Hopper (``sm_90a``) into
``vf_fem_tpu_torch/_build/<name>-<hash>.so`` and loaded with ``ctypes``;
the hash covers the source and the compiler flags, so an edited source is
rebuilt on its next use.  Nothing is built when a module is imported: the
first kernel launch builds.  A missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_loaded: dict = {}


def find_nvcc() -> str:
    candidates = [Path("/usr/local/cuda/bin/nvcc")]
    if os.environ.get("CUDA_HOME"):
        candidates.insert(0, Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` unless an up-to-date build exists; return
    the path of the shared library."""
    src = CSRC / source
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    lib = BUILD_DIR / f"{src.stem}-{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a temporary name and rename: concurrent builds never
    # load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {src.name} (exit {proc.returncode}):\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


def load(source: str, signatures: dict) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<source>``; ``signatures`` maps
    each entry point to its ``argtypes``.  Every entry point returns an
    int (a ``cudaError_t``)."""
    if source not in _loaded:
        lib = ctypes.CDLL(str(build(source)))
        for name, argtypes in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _loaded[source] = lib
    return _loaded[source]
