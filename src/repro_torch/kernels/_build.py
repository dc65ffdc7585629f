"""Build and load the port's CUDA kernels, at first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds).  Libraries land in
``build/repro_torch_kernels/`` at the root of the checkout, named by a hash
of their sources and flags, so an edited kernel rebuilds and an unchanged
one is reused.  `build` starts one ``nvcc`` per source, all together.

Every C entry returns ``cudaGetLastError()`` after its launch; `check`
turns a nonzero code into an exception.  ``LAUNCHES`` counts, per kernel,
how many times it was launched (each launch function, the CUDA
implementation of its op in `kernels.library`, adds one right after the
launch and nowhere else).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("era_sharpen", "distill_loss", "ssd_chunk")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES = {"era_sharpen": 0, "weighted_era_sharpen": 0,
            "distill_loss_fwd": 0, "distill_loss_bwd": 0, "ssd_chunk": 0}

_LIBS: dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [shutil.which("nvcc")]
    if cuda_home:
        candidates.append(os.path.join(cuda_home, "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for cand in candidates:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (searched PATH, $CUDA_HOME and the "
                       "default toolkit location); the port's CUDA kernels "
                       "cannot be built")


def lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, str]:
    """Compile every library in ``names`` that is not built yet, one nvcc
    process per source, all started together.  Returns each compiled
    source's nvcc output (``-Xptxas -v``: registers, shared memory, spills);
    raises if any compile fails."""
    todo = [n for n in names if not lib_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        out = lib_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, errors = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{name}.cu: nvcc exited with {proc.returncode}\n"
                          f"{logs[name]}")
        else:
            os.replace(tmp, out)   # atomic: a concurrent loader never sees half a file
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return logs


def library(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed.
    ``signatures`` maps each C entry to its ``argtypes``; every entry
    returns an ``int`` (its ``cudaGetLastError()``)."""
    lib = _LIBS.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(lib_path(name)))
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    import torch
    return torch.cuda.get_device_properties(device).multi_processor_count


def require_device(t, what: str) -> None:
    """The ops run on CPU tensors (their plain versions) and CUDA tensors
    (the kernels), and trace on fake tensors of either device; anything
    else is refused."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: expected a CUDA or CPU tensor, got "
                         f"{t.device}")


def require_cuda(t, what: str) -> None:
    """A launch takes a CUDA tensor; anything else is refused."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA or CPU tensor, got "
                         f"{t.device}")
