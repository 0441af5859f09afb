"""Build and load the port's hand-written CUDA kernels (one shared helper).

Each source under ``csrc/`` is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``, on first
use, into ``build/kernels/`` at the root of a source checkout, or into
``~/.cache/repro_torch/kernels`` (``$XDG_CACHE_HOME`` if set) when the
package is installed elsewhere.  A library is named by a hash of its
source and of the ``csrc/`` headers it includes (``#include "x.cuh"``,
followed through headers), so an edited source or header is rebuilt.
Nothing is compiled when this module is imported.  The flash kernel's
tensor maps are encoded through ``cudaGetDriverEntryPoint``, so no library
links against the driver (``-lcuda``).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
# Every kernel source of the port, by kernel name (``csrc/<name>.cu``).
SOURCES = ("mrc_logw", "bernoulli_kl", "segment_logw", "flash_attn", "rwkv_chunk",
           "threefry_draw")


def _build_dir() -> Path:
    """``build/kernels`` of the source checkout this module lies in, else a
    per-user cache (an installed package has no checkout to build into)."""
    root = Path(__file__).resolve().parents[3]
    if (root / "pyproject.toml").is_file() and (root / "src" / "repro_torch").is_dir():
        return root / "build" / "kernels"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "repro_torch" / "kernels"


BUILD_DIR = _build_dir()
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
INT32_MAX = 2 ** 31 - 1


def cuda_tool(tool: str) -> str:
    """Path of a CUDA toolkit program (``nvcc``, ``cuobjdump``): on PATH, else
    under ``$CUDA_HOME/bin`` or ``/usr/local/cuda/bin``."""
    found = shutil.which(tool)
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / tool
    if cand.exists():
        return str(cand)
    raise RuntimeError(f"{tool} not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def source(name: str) -> Path:
    return CSRC / f"{name}.cu"


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def inputs(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and every local header it includes, in the order
    first met (the files whose bytes name the library)."""
    seen, todo = [], [source(name)]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        todo += [path.parent / m.decode() for m in _INCLUDE.findall(path.read_bytes())]
    return seen


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for path in inputs(name):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    tag = digest.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build(name: str) -> dict:
    """Compile ``csrc/<name>.cu`` unless this source's library exists.

    Returns ``{"path", "seconds", "built", "log"}``; ``log`` holds nvcc's
    ``-Xptxas -v`` report (registers, shared memory, spills).
    """
    so = library_path(name)
    if so.exists():
        return {"path": str(so), "seconds": 0.0, "built": False, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([cuda_tool("nvcc"), *NVCC_FLAGS, "-o", tmp, str(source(name))],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) on {source(name)}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return {"path": str(so), "seconds": time.perf_counter() - t0, "built": True,
            "log": proc.stdout + proc.stderr}


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built on first use).

    Every library exports ``<name>_error_string(int) -> const char*``.
    """
    lib = ctypes.CDLL(build(name)["path"])
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


def current_stream(device: torch.device) -> int:
    """The raw handle of ``device``'s current stream.  ``torch.cuda
    .current_stream`` builds a Stream object, a few microseconds a call; the
    raw getter (the one Triton's launcher calls) does not."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def launch(device: torch.device, fn, *args) -> int:
    """Call a library's launch function ``fn(*args, stream)`` with the
    current stream of ``device``, on that device; returns its CUDA error
    code.  ``device`` is made the current device only when it is not
    already (entering ``torch.cuda.device`` costs microseconds a call, and
    most calls need no switch)."""
    if device.index == torch.cuda.current_device():
        return fn(*args, current_stream(device))
    with torch.cuda.device(device):
        return fn(*args, current_stream(device))


def check(name: str, lib: ctypes.CDLL, rc: int) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if rc != 0:
        msg = getattr(lib, f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} ({msg})")


def check_cuda_inputs(name: str, ref, **tensors) -> None:
    """Device, type and layout checks shared by the kernel wrappers: every
    tensor lies on ``ref``'s CUDA device, is contiguous and is float32
    (``seg_ids`` int32)."""
    for tname, t in tensors.items():
        if t.device.type != "cuda" or t.device != ref.device:
            raise ValueError(f"{name}: {tname} is on {t.device}, expected the "
                             f"CUDA device {ref.device}")
        want = torch.int32 if tname == "seg_ids" else torch.float32
        if t.dtype != want:
            raise TypeError(f"{name}: {tname} is {t.dtype}, expected {want}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous")


def check_key(name: str, kname: str, key: torch.Tensor, shapes: tuple, ref) -> int:
    """Check a threefry key (int64 words) against the allowed ``shapes``, on
    ``ref``'s device and contiguous; returns its stride in int64 words
    between clients: 0 for one (2,) key, 2 for one per client."""
    if key.dtype != torch.int64:
        raise TypeError(f"{name}: {kname} is {key.dtype}, expected int64 (uint32 words)")
    if tuple(key.shape) not in shapes:
        raise ValueError(f"{name}: {kname} {tuple(key.shape)} must be one of {shapes}")
    if key.device != ref.device or not key.is_contiguous():
        raise ValueError(f"{name}: {kname} must be contiguous on {ref.device}")
    return 0 if key.dim() == 1 else 2


def check_strided_inputs(name: str, tensors: dict, dtypes) -> None:
    """Checks shared by the model kernels' wrappers (which read their inputs
    through strides): one CUDA device, one of ``dtypes`` for all, unit
    stride along the last axis, no autograd (these kernels have no
    backward, as the TPU kernels had none)."""
    ref = next(iter(tensors.values()))
    for tname, t in tensors.items():
        if t.device.type != "cuda" or t.device != ref.device:
            raise ValueError(f"{name}: {tname} is on {t.device}, expected the CUDA "
                             f"device {ref.device}")
        if t.dtype not in dtypes or t.dtype != ref.dtype:
            raise TypeError(f"{name}: {tname} is {t.dtype}; expected one of "
                            f"{sorted(map(str, dtypes))}, the same for every input")
        if t.requires_grad:
            raise RuntimeError(f"{name}: {tname} requires grad, but the kernel has no "
                               "backward")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: {tname} must have unit stride along its last axis")
