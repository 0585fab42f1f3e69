"""Build and load the port's CUDA kernels (``csrc/<name>.cu``).

Each source compiles with ``nvcc`` into a shared library with a plain C
interface, loaded with ``ctypes`` — no PyTorch headers, so a build takes
seconds.  The library lands in ``build/repro_torch/`` at the root of the
checkout (``.gitignore`` lists ``build/``), named by a hash of the source
and the flags: an edited source builds anew at first use, an unchanged
one loads from there.  ``defines`` (``NAME=value`` strings, passed as
``-D``) build a variant of a source beside its default.  Nothing is built
when a module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: Shared memory a CTA may use on Hopper (232,448 B of an SM's 256 KB).
SMEM_LIMIT = 232_448

_LIBS: dict[tuple, ctypes.CDLL] = {}
#: ``-Xptxas -v`` report (registers, shared memory, spills) of each build
#: made by this process, by kernel name (and ``defines``, when given, as
#: ``name[D1,D2]``).
PTXAS_REPORT: dict[str, str] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``, then
    ``PATH``."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return found


def _flags(defines: tuple) -> tuple:
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def report_key(name: str, defines: tuple = ()) -> str:
    return f"{name}[{','.join(defines)}]" if defines else name


def library_path(name: str, defines: tuple = ()) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(_flags(defines)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(name: str, defines: tuple = ()) -> float:
    """Compile ``csrc/<name>.cu`` (with ``defines``) unless it is built
    already.  Returns the seconds the build took (0.0 when it was on disk);
    raises with the compiler's output when the build fails."""
    out = library_path(name, defines)
    if out.exists():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc(), *_flags(defines), "-o", tmp, str(CSRC / f"{name}.cu")],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    PTXAS_REPORT[report_key(name, defines)] = proc.stdout
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}")
    os.replace(tmp, out)  # atomic: a reader never sees half a file
    return time.perf_counter() - t0


def load(name: str, defines: tuple = ()) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (with ``defines``), built
    first if needed."""
    key = (name, tuple(defines))
    lib = _LIBS.get(key)
    if lib is None:
        build(name, key[1])
        lib = _LIBS[key] = ctypes.CDLL(str(library_path(name, key[1])))
    return lib


def tensor_ptr(x: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
               device: torch.device) -> int:
    """``x``'s data pointer for a kernel argument, after checking that it
    is a contiguous ``dtype`` tensor of ``shape`` on ``device``."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(x).__name__}")
    if x.device != device or x.dtype != dtype or tuple(x.shape) != tuple(shape):
        raise ValueError(
            f"{name}: expected {dtype} {tuple(shape)} on {device}, got "
            f"{x.dtype} {tuple(x.shape)} on {x.device}"
        )
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    return x.data_ptr()
