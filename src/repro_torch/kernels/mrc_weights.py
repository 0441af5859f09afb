"""MRC importance log-weights: the hand-written CUDA kernel and its plain version.

    logW[nb, i] = sum_s x[nb, i, s] * a[nb, s] + sum_s b[nb, s]

Port of ``repro.kernels.mrc_weights.mrc_logw_pallas`` (the TPU kernel).
The CUDA source is ``csrc/mrc_logw.cu``; its header gives the bound and the
design.  It is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and bound with ``ctypes``, on first use, into
``build/kernels/`` at the root of a source checkout, or into
``~/.cache/repro_torch/kernels`` (``$XDG_CACHE_HOME`` if set) when the
package is installed elsewhere.  The library is named by a hash of the
source, so an edited source is rebuilt.  Nothing is compiled when this
module is imported.

``mrc_logw_ref`` is the plain PyTorch version: the CPU route of
``kernels.ops.mrc_logw`` and the oracle the kernel is held against on the
card.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "mrc_logw.cu"


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
_INT32_MAX = 2 ** 31 - 1


def mrc_logw_ref(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: x (NB, NIS, S), a/b (NB, S) -> (NB, NIS)."""
    return torch.einsum("bis,bs->bi", x, a) + b.sum(-1, keepdim=True)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the mrc_logw CUDA kernel cannot be built")


def library_path() -> Path:
    tag = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libmrc_logw-{tag}.so"


def build() -> dict:
    """Compile the kernel unless this source's library exists.

    Returns ``{"path", "seconds", "built", "log"}``; ``log`` holds nvcc's
    ``-Xptxas -v`` report (registers, shared memory, spills).
    """
    so = library_path()
    if so.exists():
        return {"path": str(so), "seconds": 0.0, "built": False, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) on {SOURCE}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return {"path": str(so), "seconds": time.perf_counter() - t0, "built": True,
            "log": proc.stdout + proc.stderr}


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build()["path"])
    vp = ctypes.c_void_p
    lib.mrc_logw_launch.argtypes = [vp, vp, vp, vp, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_int, vp]
    lib.mrc_logw_launch.restype = ctypes.c_int
    lib.mrc_logw_error_string.argtypes = [ctypes.c_int]
    lib.mrc_logw_error_string.restype = ctypes.c_char_p
    return lib


def mrc_logw_cuda(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream; raises on bad input."""
    if x.dim() != 3 or a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"mrc_logw needs x (NB, NIS, S) and a, b (NB, S); got "
                         f"{tuple(x.shape)}, {tuple(a.shape)}, {tuple(b.shape)}")
    nb, nis, s = x.shape
    if tuple(a.shape) != (nb, s) or tuple(b.shape) != (nb, s):
        raise ValueError(f"mrc_logw: a {tuple(a.shape)} and b {tuple(b.shape)} "
                         f"must both be ({nb}, {s}) for x {tuple(x.shape)}")
    for name, t in (("x", x), ("a", a), ("b", b)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"mrc_logw: {name} is on {t.device}, expected the "
                             f"CUDA device of x ({x.device})")
        if t.dtype != torch.float32:
            raise TypeError(f"mrc_logw: {name} is {t.dtype}, expected float32")
        if not t.is_contiguous():
            raise ValueError(f"mrc_logw: {name} must be contiguous")
    if max(nb, nis, s) > _INT32_MAX:
        raise ValueError(f"mrc_logw: dims {tuple(x.shape)} exceed int32")
    out = torch.empty((nb, nis), dtype=torch.float32, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.mrc_logw_launch(x.data_ptr(), a.data_ptr(), b.data_ptr(),
                                 out.data_ptr(), nb, nis, s, stream)
    if rc != 0:
        raise RuntimeError(f"mrc_logw kernel launch failed: CUDA error {rc} "
                           f"({lib.mrc_logw_error_string(rc).decode()})")
    return out
