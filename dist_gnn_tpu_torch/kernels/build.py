"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
first use into ``_build/`` beside this package (listed in ``.gitignore``)
as ``lib<name>-<hash>.so``, the hash covering the source and the flags, so
a stale library is never loaded.  nvcc by hand with a C interface builds in
seconds; ``torch.utils.cpp_extension.load`` would compile PyTorch's headers
for minutes.  :func:`build_all` starts one nvcc per source, all at once.

Nothing here runs at import: the CPU tests import every module, and a
build starts only when a CUDA tensor reaches a kernel wrapper (or a caller
asks for :func:`build_all`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("gather", "gat")  # csrc/<name>.cu, one library each

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256(
        (CSRC_DIR / f"{name}.cu").read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Compile every missing library, one nvcc process per source, all in
    parallel.  Returns each name's compiler log (``-Xptxas -v`` prints the
    registers and spills of every kernel); raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp,
            out,
        )
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            continue
        os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
        (BUILD_DIR / f"lib{name}.log").write_text(logs[name])
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n"
            + "\n".join(logs[n] for n in failed)
        )
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``lib<name>``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_all((name,))
        lib = _LOADED[name] = ctypes.CDLL(str(path))
    return lib
