"""Build the CUDA kernels at first use and load them with ctypes.

Each source under ``csrc/`` has a plain C interface and compiles on its
own with::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o lib<name>-<hash>.so csrc/<name>.cu

into ``_build/`` beside this file (listed in ``.gitignore``).  The library
name carries a hash of the source, the headers under ``csrc/`` and the
flags, so an edited source or header is rebuilt and never loaded stale.  All missing libraries are compiled
together, one nvcc process per source.  Never ``--use_fast_math``: the
kernels compare against +inf and BIG exactly.

Nothing here runs at import time: the CPU tests import every module on a
machine without nvcc.

Every failure to build, load or launch a kernel raises :class:`KernelError`,
so a caller that tolerates other errors can let this one through.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Any, Dict, Tuple

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().with_name("_build")
SOURCES = ("spf_dense", "spf_warm", "route_select", "spf_sweep", "repair_sweep", "sweep_select")
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

#: nvcc's output per source from this process's builds (ptxas -v lists
#: each kernel's registers, shared memory and spills)
BUILD_LOGS: Dict[str, str] = {}

_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[Tuple[str, str], Any] = {}
_lock = threading.Lock()


class KernelError(RuntimeError):
    """A CUDA kernel of ``csrc/`` could not be built, loaded or launched."""


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise KernelError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a hash of the source,
    every header of ``csrc/`` (so an edited header is never loaded stale)
    and the flags."""
    digest = hashlib.sha256()
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_all() -> None:
    """Compile every source whose library is missing, all nvcc processes
    started together; raises with nvcc's output if any fails."""
    with _lock:
        pending = [n for n in SOURCES if not library_path(n).exists()]
        if not pending:
            return
        nvcc = nvcc_path()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        for name in pending:
            out = library_path(name)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )
            procs.append((name, out, tmp, proc))
        failures = []
        for name, out, tmp, proc in procs:
            log, _ = proc.communicate()
            BUILD_LOGS[name] = log
            if proc.returncode != 0:
                failures.append(f"nvcc failed for {name}.cu:\n{log}")
            else:
                os.replace(tmp, out)
        if failures:
            raise KernelError("\n".join(failures))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if
    needed."""
    lib = _libs.get(name)
    if lib is None:
        build_all()
        try:
            lib = ctypes.CDLL(str(library_path(name)))
        except OSError as e:
            raise KernelError(f"cannot load the library of {name}.cu: {e}") from e
        _libs[name] = lib
    return lib


def function(lib_name: str, symbol: str, argtypes):
    """A C entry point of ``csrc/<lib_name>.cu`` with its argument types
    declared (pointers and the stream as ``c_void_p``, so ctypes never
    cuts them to 32 bits) and an ``int`` cudaError result; bound once per
    process."""
    fn = _fns.get((lib_name, symbol))
    if fn is None:
        try:
            fn = getattr(load(lib_name), symbol)
        except AttributeError as e:
            raise KernelError(f"{lib_name}.cu has no entry point {symbol}: {e}") from e
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[(lib_name, symbol)] = fn
    return fn


def check_tensor(name: str, t, dtype, shape, device) -> None:
    """Raise unless ``t`` has the device, dtype, shape and contiguity the
    kernel reads it with."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device) -> ctypes.c_void_p:
    """PyTorch's current stream on ``device``: kernels launch there and do
    not synchronize."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


@functools.cache
def _sm_count(index: int) -> int:
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device) -> int:
    """The SM count of the CUDA ``device``, read once per device (a tile
    rule reads it on every call)."""
    return _sm_count(device.index if device.index is not None else 0)


def check_launch(name: str, rc: int) -> None:
    """Raise if a C entry point reported a CUDA error (a refused launch
    never runs, and a later synchronize would not report it)."""
    if rc != 0:
        raise KernelError(f"CUDA kernel {name} failed to launch: cudaError {rc}")
