"""Build and load the port's CUDA kernels (``csrc/*.cu``) as one library.

Each source is compiled by its own ``nvcc`` process, all started together,
for ``sm_90a``; the objects are linked into one shared library with a plain
C interface and loaded with ``ctypes``. Nothing is built at import time: the
first kernel launch (or ``load_library()``) builds into ``build/kernels/``
at the repository root, keyed by a hash of the sources, so an unchanged
tree reuses its library.
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
from typing import Dict, List

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-O3", "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-lineinfo"]
# the head dims the flash and decode attention kernels are built for
# (csrc/common.cuh: with_head_dim); each wrapper refuses any other
ATTENTION_HEAD_DIMS = (16, 32, 64, 96, 128)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float

# C signatures of the entry points in csrc/ (all return cudaError_t as int)
SIGNATURES: Dict[str, List] = {
    "repro_rmsnorm": [_P, _P, _P, _I, _I, _F, _I, _P],
    "repro_decode_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I]
    + [_L] * 8 + [_I, _I, _F, _I, _P],
    "repro_decode_attention_int8": [_P] * 7 + [_I] * 5 + [_L] * 14
    + [_I, _I, _F, _I, _P],
    "repro_flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I]
    + [_L] * 12 + [_I, _I, _I, _F, _I, _P],
    "repro_flash_attention_split": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I]
    + [_L] * 12 + [_I, _I, _I, _F, _I, _P],
    "repro_wkv": [_P] * 8 + [_I] * 4 + [_L] * 12 + [_I, _P],
    "repro_rope": [_P] * 7 + [_I] * 6 + [_L] * 15 + [_F, _P, _I, _I, _P],
    "repro_mla_decode": [_P] * 4 + [_I] * 3 + [_L] * 4 + [_F, _P],
    "repro_rmsnorm_geometry": [_I, _I, _I, _I, ctypes.POINTER(_I)],
    "repro_decode_attention_occupancy": [_I] * 6 + [ctypes.POINTER(_I)],
    "repro_empty": [_P],
}

# what the last build printed (ptxas register/shared-memory report) and took
build_log: Dict[str, object] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels can only be built "
                       "on a machine with the CUDA toolkit")


def _digest(csrc: Path) -> str:
    h = hashlib.sha256()
    for p in sorted(csrc.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(csrc: Path = CSRC) -> Path:
    """Compile every source of csrc (by default this package's) in parallel
    and link them into one library."""
    csrc = Path(csrc)
    lib_path = BUILD_DIR / f"librepro_kernels_{_digest(csrc)}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sorted(csrc.glob("*.cu")):
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, objs, failed = [], [], []
        for src, obj, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            objs.append(str(obj))
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
        tmp_lib = Path(tmp) / lib_path.name
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", *objs, "-o",
                               str(tmp_lib)], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"link failed:\n{link.stdout}{link.stderr}")
        os.replace(tmp_lib, lib_path)
    build_log["seconds"] = time.perf_counter() - t0
    build_log["ptxas"] = "\n".join(logs)
    return lib_path


@functools.lru_cache(maxsize=None)
def load_library(csrc: Path = CSRC) -> ctypes.CDLL:
    """The library built from csrc (by default this package's sources) with
    every entry point's ``argtypes`` set."""
    lib = ctypes.CDLL(str(build(csrc)))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is None:  # an older tree (kernel_ab.py) lacks the newer helpers
            continue
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


# element-type codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def use_plain(name: str, *tensors: torch.Tensor) -> bool:
    """True for CPU tensors (take the plain version), False for CUDA tensors
    (launch the kernel); raises for mixed or other devices, and for CUDA
    inputs that autograd would need a backward for (``refuse_autograd``)."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{name}: tensors on several devices {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    refuse_autograd(name, *tensors)
    return False


def refuse_autograd(name: str, *tensors: torch.Tensor) -> None:
    """Raise if grad mode is on and an input requires grad: a kernel has no
    backward, and its output would silently cut the graph. Training takes
    the differentiable route (``forward(..., is_train=True)``, what
    ``loss_fn`` runs); serving runs under ``torch.no_grad()``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad under grad mode, and the CUDA "
            "kernel has no backward; train on the training route "
            "(forward(..., is_train=True) / loss_fn), or call the kernel "
            "under torch.no_grad()")


def dtype_code(name: str, *tensors: torch.Tensor) -> int:
    dts = {t.dtype for t in tensors}
    if len(dts) != 1 or next(iter(dts)) not in DTYPE_CODES:
        raise TypeError(f"{name}: needs one dtype of {list(DTYPE_CODES)}, got "
                        f"{sorted(map(str, dts))}")
    return DTYPE_CODES[dts.pop()]


def check_aligned(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor's base pointer and every stride but the
    last (of dimensions longer than 1) are multiples of 16 bytes: the
    attention and WKV kernels copy rows with 16-byte vector loads."""
    for t in tensors:
        es = t.element_size()
        bad = [s for n, s in zip(t.shape[:-1], t.stride()[:-1])
               if n > 1 and (s * es) % 16]
        if t.data_ptr() % 16 or bad:
            raise ValueError(f"{name}: base pointer and strides must be "
                             f"multiples of 16 bytes, got pointer % 16 = "
                             f"{t.data_ptr() % 16}, strides {t.stride()} of "
                             f"{es}-byte elements")


def stream_ptr(t: torch.Tensor) -> int:
    """The current CUDA stream of t's device, as the C entry points take it."""
    return torch.cuda.current_stream(t.device).cuda_stream
