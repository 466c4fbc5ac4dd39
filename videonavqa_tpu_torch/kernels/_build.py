"""Build the CUDA sources in ``csrc/`` with nvcc and load them with ctypes.

Each source compiles on its own into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), at first use, into
``videonavqa_tpu_torch/_build/`` (git-ignored). The library name carries a
hash of the source and of the headers in ``csrc/``, so an edited kernel is
rebuilt. ``build_all`` starts one nvcc per source, all at once. A failed
build raises: nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("film_reencode", "attn_tail", "int8_matmul", "lstm", "vgg_block1", "conv3x3_int8")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# ptxas register / shared-memory report of each build, by source name
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _lib_path(name: str) -> Path:
    digest = hashlib.sha1()
    for path in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        digest.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _start(name: str):
    out = _lib_path(name)
    if out.exists():
        return None
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.so")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    build_logs[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)


def build_all() -> None:
    """Compile every kernel source that is not built yet, in parallel."""
    with _lock:
        started = {name: _start(name) for name in SOURCES}
        failures = []
        for name, s in started.items():  # wait for every nvcc, then report
            try:
                _finish(name, s)
            except RuntimeError as err:
                failures.append(err)
        if failures:
            raise failures[0]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = ctypes.CDLL(str(_lib_path(name)))
            _libs[name] = lib
        return lib


def function(lib_name: str, symbol: str, argtypes):
    """A C function of ``csrc/<lib_name>.cu`` that returns a CUDA error code."""
    fn = getattr(load(lib_name), symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return fn


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def require(t: torch.Tensor, name: str, dtype, shape=None, device=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of this dtype and shape
    (and on ``device``, where given), and unless autograd would need a
    gradient through it: no kernel has a backward pass, and its outputs carry
    no ``grad_fn``, so training on them would leave the gradients of the
    tensors before it silently zero."""
    if torch.is_grad_enabled() and t.requires_grad:
        raise RuntimeError(f"{name}: the kernel has no backward pass, and this input requires"
                           " grad; train through the plain version (train=True forwards do)")
    if t.device.type != "cuda" or (device is not None and t.device != device):
        raise ValueError(f"{name}: expected a CUDA tensor on {device or 'cuda'}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
