"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``build/kernels/lib<name>-<hash>.so`` at the repository root; the hash
covers the source and the command, so an edited source rebuilds and an
unchanged one loads the library already built.  :func:`build` starts one
``nvcc`` per source, all at once.  Nothing here runs at import time.
:func:`no_grad_only` is the wrappers' shared guard for kernels that have
no backward.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Sequence

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home and (Path(cuda_home) / "bin" / "nvcc").exists():
        return str(Path(cuda_home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def nvcc_command(src: Path, out: Path, nvcc: str = "nvcc") -> list[str]:
    """The compile command for one source: Hopper (sm_90a) only, a shared
    library with a C interface, register/shared-memory use printed by
    ptxas."""
    return [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-lineinfo",
            "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
            "-o", str(out), str(src)]


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes())
    digest.update(" ".join(nvcc_command(Path("s"), Path("o"))).encode())
    return src, BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names: Sequence[str]) -> dict[str, Path]:
    """Compile every named source that is not built yet, all in parallel.
    Returns name -> library path; raises with the compiler's output on a
    failure.  The compiler's report is kept beside each library (.log)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: dict[str, Path] = {}
    procs = []
    for name in names:
        src, lib = _target(name)
        out[name] = lib
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp.so")
        cmd = nvcc_command(src, tmp, nvcc_path())
        procs.append((name, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, lib, tmp, proc in procs:
        log, _ = proc.communicate()
        lib.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _LIBS[name] = lib
        return lib


def wants_grad(*tensors) -> bool:
    """Whether autograd would have to go through a call on ``tensors``."""
    return torch.is_grad_enabled() and any(x.requires_grad for x in tensors)


def no_grad_only(name: str, *tensors) -> None:
    """Refuse a call that autograd would have to go through: the kernel has
    no backward, and its output would silently cut the gradient."""
    if wants_grad(*tensors):
        raise RuntimeError(f"{name}: no gradient through this kernel; call it under "
                           "torch.no_grad() or on tensors that do not require grad")
