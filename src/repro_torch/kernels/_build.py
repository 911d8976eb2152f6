"""Build the port's CUDA kernels with ``nvcc`` and bind them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles to its own shared library with a plain C
interface (no PyTorch headers, so a file builds in seconds), all ``nvcc``
processes started together.  The libraries land in
``<checkout>/build/repro_torch/<hash>/``, keyed by a hash of the sources and
flags: the first call in a fresh checkout builds, later calls load what is
there, and an edited source builds anew.  Nothing is built at import time.

Every C entry point returns the ``cudaGetLastError()`` of its launch;
:func:`check` turns a nonzero code into an exception.  Pointers and the
stream cross as ``ctypes.c_void_p``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("rmsnorm", "flash_attention", "decode_attention", "paged_attention", "rwkv6_scan",
           "mamba2_ssd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# dtype codes of csrc/common.cuh
DT_F32, DT_BF16 = 0, 1

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[str, ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the CUDA "
                       "kernels of repro_torch cannot be built on this machine")


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> Dict[str, str]:
    """Compile every missing library in parallel; return each library's
    compiler log (``-Xptxas -v``: registers, shared memory, spills).  Raises
    with the compiler's output if any build fails."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in SOURCES:
        lib = out / f"lib{name}.so"
        if lib.exists():
            continue
        tmp = out / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [_nvcc(), *NVCC_FLAGS, f"-I{CSRC}", "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        (out / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, lib)           # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return {name: (out / f"{name}.log").read_text() for name in SOURCES
            if (out / f"{name}.log").exists()}


def library(name: str) -> ctypes.CDLL:
    with _lock:
        if name not in _libs:
            path = build_dir() / f"lib{name}.so"
            if not path.exists():
                build_all()
            _libs[name] = ctypes.CDLL(str(path))
        return _libs[name]


def function(lib_name: str, fn_name: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C entry point ``fn_name`` of ``lib<lib_name>.so``, typed."""
    key = f"{lib_name}.{fn_name}"
    fn = _fns.get(key)
    if fn is None:
        fn = getattr(library(lib_name), fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return fn


def stream(device: torch.device) -> int:
    """The raw handle of PyTorch's current stream on ``device`` (an int, without
    the ``torch.cuda.Stream`` object that ``current_stream`` builds)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def check(err: int, what: str) -> None:
    if err != 0:
        name = function("rmsnorm", "cuda_error_string", [ctypes.c_int])
        name.restype = ctypes.c_char_p
        raise RuntimeError(f"{what}: CUDA error {err} ({name(err).decode()}) at launch")
