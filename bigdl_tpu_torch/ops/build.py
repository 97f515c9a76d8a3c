"""Build the port's CUDA kernel library at first use and load it with ctypes.

The library is compiled by one ``nvcc`` call for ``sm_90a`` from every
``.cu`` file under ``ops/csrc/`` (the flash forward,
``flash_attention.cu``, and its backward, ``flash_attention_bwd.cu``)
into ``build/bigdl_tpu_torch/`` at the root of the checkout, as one
shared library with a plain ``extern "C"`` interface (no PyTorch headers,
so a build takes seconds). The file name carries a hash of the flags and
of every file under ``csrc/``, so any edited source or header is rebuilt
and a stale library is never loaded.

Nothing here runs at import time: this module imports on a machine with
no CUDA toolkit, and only a CUDA launch reaches ``load``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
#: the forward's source, which names the library
SOURCE = CSRC / "flash_attention.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "bigdl_tpu_torch"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit's
    default install path."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def sources() -> list:
    """Every ``.cu`` file under ``CSRC``, in name order: the translation
    units of the one library."""
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """Where the library built from ``CSRC`` with ``NVCC_FLAGS`` lives: a
    hash of the flags and of each file's path and bytes under ``CSRC``."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(p for p in CSRC.rglob("*") if p.is_file()):
        h.update(f.relative_to(CSRC).as_posix().encode() + b"\0")
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{SOURCE.stem}-{h.hexdigest()[:16]}.so"


def build_log() -> Path:
    """The compiler's output of the build (``-Xptxas -v``: registers,
    shared memory and spills of each kernel)."""
    return library_path().with_suffix(".log")


def build() -> Path:
    """Compile the library unless its hashed ``.so`` exists; return its
    path. Raises with the compiler's output if the build fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                           *map(str, sources())], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    with open(build_log(), "w") as f:
        f.write(proc.stdout)
    if proc.returncode != 0:
        raise RuntimeError(f"CUDA kernel build failed (nvcc exit "
                           f"{proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)  # atomic: a concurrent reader never sees half
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _loaded
    with _lock:
        if _loaded is None:
            _loaded = ctypes.CDLL(str(build()))
        return _loaded
