"""Build the port's native sources and load them with ctypes.

Each ``csrc/<name>.cu`` (CUDA, compiled by nvcc) or ``csrc/<name>.cc``
(the host runtime, compiled by g++ with OpenMP) exposes a plain C
interface and is compiled on first use into ``_build/`` beside this
package (listed in ``.gitignore``) as ``lib<name>-<hash>.so``, the hash
covering the source and the flags, so a stale library is never loaded.
A build writes a file of its own and renames it into place, so processes
that build the same library at once (test workers) each load a whole one.
nvcc by hand with a C interface builds in seconds;
``torch.utils.cpp_extension.load`` would compile PyTorch's headers for
minutes.  :func:`build_all` starts one compiler per source, all at once.

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
from typing import Dict, List, Sequence

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("gather", "gat", "attention", "sampling", "host")  # csrc/<name>.cu or .cc, one library each

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
GXX_FLAGS = ("-std=c++17", "-O3", "-fPIC", "-fopenmp", "-shared")

_LOADED: Dict[object, ctypes.CDLL] = {}  # a name, or (name, *defines)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _source(name: str) -> Path:
    cu = CSRC_DIR / f"{name}.cu"
    return cu if cu.exists() else CSRC_DIR / f"{name}.cc"


def _command(src: Path, out: Path, defines: Sequence[str] = ()) -> List[str]:
    if src.suffix == ".cu":
        return [_nvcc(), *NVCC_FLAGS, *defines, "-o", str(out), str(src)]
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the host runtime needs a C++ compiler")
    return [gxx, *GXX_FLAGS, *defines, "-o", str(out), str(src)]


def _lib_path(name: str, defines: Sequence[str] = ()) -> Path:
    src = _source(name)
    flags = (*(NVCC_FLAGS if src.suffix == ".cu" else GXX_FLAGS), *defines)
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names: Sequence[str] = SOURCES, defines: Sequence[str] = ()) -> Dict[str, str]:
    """Compile every missing library, one compiler process per source, all
    in parallel, with the extra ``defines`` (``-DNAME=value``; a library of
    its own).  Returns each name's compiler log (``-Xptxas -v`` prints the
    registers and spills of every kernel); raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name, defines)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = _command(_source(name), tmp, defines)
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
            "the build failed for " + ", ".join(failed) + ":\n"
            + "\n".join(logs[n] for n in failed)
        )
    return logs


def load(name: str, defines: Sequence[str] = ()) -> ctypes.CDLL:
    """The loaded library ``lib<name>`` (built with the extra ``defines``),
    built first if needed."""
    key = (name, *defines) if defines else name
    lib = _LOADED.get(key)
    if lib is None:
        path = _lib_path(name, defines)
        if not path.exists():
            build_all((name,), defines)
        lib = _LOADED[key] = ctypes.CDLL(str(path))
    return lib
