"""Build the CUDA sources under ``csrc/`` with nvcc and load them.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface, loaded with ``ctypes``.  Libraries land in
``<repo>/build/kernels/<hash of the sources>/``, so an unchanged tree
never rebuilds and a changed one never loads a stale library.  Nothing
is built when this module is imported: the first wrapper call on a CUDA
tensor builds (``build_all`` builds every source at once, one nvcc
process each, all started together).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: dict[str, ctypes.CDLL] = {}


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_dir() -> Path:
    h = hashlib.sha256()
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16]


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME  # noqa: PLC0415
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (nvcc on PATH or CUDA_HOME set)")


def build_all(names=None) -> dict[str, str]:
    """Compile every named source that is not built yet, in parallel.

    Returns ``{name: nvcc's output}`` for the sources it compiled (with
    ``-Xptxas -v``: registers, shared memory and spills per kernel).
    Raises RuntimeError naming the source if nvcc fails.
    """
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names or sources():
        lib = out_dir / f"lib{name}.so"
        if lib.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, lib)
    logs, failed = {}, []
    for name, (proc, tmp, lib) in procs.items():  # wait for every nvcc
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed on csrc/{name}.cu:\n{logs[name]}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(build_dir() / f"lib{name}.so"))
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


# devices a wrapper runs its plain version on: the CPU, and ``meta``
# (shapes only, for the dry-run; nothing to compute)
PLAIN_DEVICES = ("cpu", "meta")


def is_dtensor(x) -> bool:
    """Whether ``x`` is a ``DTensor`` (none exists before
    ``torch.distributed.tensor`` is imported, so this imports nothing)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def check_local(what: str, *tensors) -> None:
    """Raise on a DTensor: a kernel reads its input's data pointer, which
    must be a local shard's (``ops`` hands the kernels ``to_local()``
    shards)."""
    if any(is_dtensor(t) for t in tensors):
        raise TypeError(f"{what}: got a DTensor; the kernel takes local "
                        f"shards (call it through repro_torch.kernels.ops)")


def check_no_grad(what: str, *tensors) -> None:
    """Raise if grad is enabled and an input requires grad: a raw kernel
    wrapper has no backward, and the tensor it returns would silently
    drop the gradient.  Differentiable calls go through the wrapper's
    ``torch.autograd.Function`` (``ops.attention_op``, ``ops.rglru_op``)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: an input requires grad, and this raw kernel wrapper "
            f"has no backward; call it through its autograd Function "
            f"(repro_torch.kernels.ops) or under torch.no_grad()")


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = lib.kernel_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


P = ctypes.c_void_p
I32 = ctypes.c_int
F32 = ctypes.c_float
