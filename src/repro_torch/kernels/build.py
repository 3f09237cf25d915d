"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``. Builds
happen at first use, on the machine with the card, into ``build/kernels/``
at the root of the checkout (listed in ``.gitignore``); a library's file name
carries a hash of its sources and flags, so an edited source is rebuilt and
a stale library is never loaded. :func:`build_all` starts one ``nvcc`` per
source, all at once.

Nothing here runs at import time: the CPU tests import every module, and
the CPU path never needs a compiler.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("flash_decode_paged", "flash_prefill", "flash_decode",
           "rwkv6_chunk")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# dtype codes of the C entry points (csrc/common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    return str(Path(home) / "bin" / "nvcc")


def _library_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def build_all(names: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Compile every source whose library is missing, one ``nvcc`` process
    per source, all started together. Returns ``{name: compiler output}``
    (``ptxas`` register and shared-memory report; empty when the library was
    already built). Raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {name: "" for name in names}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(f"{name} (exit {proc.returncode}):\n{logs[name]}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    build_all()
    lib = ctypes.CDLL(str(_library_path(name)))
    lib.repro_kernel_error_string.argtypes = [ctypes.c_int]
    lib.repro_kernel_error_string.restype = ctypes.c_char_p
    return lib


def check_launch(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error (it returns
    ``cudaGetLastError()`` right after the launch)."""
    if code != 0:
        msg = lib.repro_kernel_error_string(code).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({code})")


def current_stream(device: torch.device) -> int:
    """The raw handle of PyTorch's current stream on ``device`` (the call
    Triton's launcher makes: a fraction of ``torch.cuda.current_stream``'s
    host time, which counts in a host-bound decode loop)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def require_aligned(what: str, *tensors: torch.Tensor) -> None:
    """Kernels that move data in 16-byte copies need 16-byte-aligned
    operands (a view at an odd offset is not)."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{what}: operands must be 16-byte aligned")


def refuse_grad(what: str, *tensors) -> None:
    """The kernels have no backward: their wrappers return fresh tensors
    filled outside autograd, so a gradient through one would be dropped
    without a word. Raise instead, on the CPU too, when grad mode is on
    and a float operand requires grad."""
    if torch.is_grad_enabled() and any(
            t is not None and t.is_floating_point() and t.requires_grad
            for t in tensors):
        raise RuntimeError(
            f"{what}: the kernel has no backward, and an operand requires "
            f"grad; call it under torch.no_grad(), or train through the "
            f"plain attention (forward_seq(..., attn_impl='chunked'))")


# devices whose tensors a wrapper hands to its kernel's plain version: the
# CPU's, and ``meta``, whose tensors hold no values (a shape-only trace)
PLAIN_DEVICES = ("cpu", "meta")


def plain_device(t: torch.Tensor) -> bool:
    """Whether a wrapper computes ``t``'s call with its plain version: a
    tensor on the CPU or on ``meta``, or a DTensor whose local shard is.
    Any other device goes on to the CUDA checks, which launch or raise."""
    local = getattr(t, "_local_tensor", t)
    return local.device.type in PLAIN_DEVICES


def require_cuda_operands(what: str, *tensors: torch.Tensor) -> None:
    """Kernel wrappers take CUDA tensors on one device, contiguous."""
    index = tensors[0].get_device()
    for t in tensors:
        if not t.is_cuda or t.get_device() != index:
            raise ValueError(f"{what}: operands must share one CUDA device "
                             f"(got {t.device} and {tensors[0].device})")
        if not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous")
