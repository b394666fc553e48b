"""Build and load the hand-written CUDA kernels.

Every `csrc/*.cu` is compiled by `nvcc` for sm_90a (one process per source,
all started together), linked into one shared library with a plain C
interface and loaded with `ctypes`. The library lives under
`build/repro_torch/<hash of the sources>/` at the root of the checkout, so an
edited source rebuilds and an unchanged one is reused. The build happens at
the first kernel launch, never at import: the CPU tests import every module
on machines that have no `nvcc`.

A missing `nvcc` or a failed build raises; there is no stub.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import torch

__all__ = ["LAUNCHES", "library", "library_path", "check", "stream_of", "dtype_code",
           "sm_count", "row_strides", "check_aligned", "refuse_grad"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# Kernel launches, one count per kernel (decode_attention's lse mode under a
# key of its own), raised by each wrapper where it launches its kernel and
# nowhere else.
LAUNCHES: Dict[str, int] = {"rmsnorm": 0, "rmsnorm_bwd": 0, "flash_attention": 0,
                            "decode_attention": 0, "decode_attention_lse": 0}

# dtype codes shared with csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "rmsnorm_fwd": [_P] * 3 + [_L] * 3 + [_F] + [_I] * 6 + [_P],
    "rmsnorm_bwd": [_P] * 6 + [_L] * 4 + [_F] + [_I] * 7 + [_P],
    "flash_attention_fwd": [_P] * 4 + [_I] * 5 + [_L] * 12 + [_I] * 5 + [_F, _I, _P],
    "decode_attention_fwd": [_P] * 9 + [_I] * 6 + [_L] * 11 + [_I] * 2 + [_F, _I, _P],
}

_LIB: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    cands = [shutil.which("nvcc")]
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cands.append(str(Path(home) / "bin" / "nvcc"))
    for c in cands:
        if c and Path(c).is_file():
            return c
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels cannot be built"
    )


def _sources_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _build(out: Path) -> None:
    nvcc = _nvcc()
    sources = sorted(CSRC.glob("*.cu"))
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        procs = []
        for src in sources:
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for src, _, proc in procs:
            log, _ = proc.communicate()
            logs.append(f"== {src.name}\n{log}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        lib = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
             *[str(o) for _, o, _ in procs], "-o", str(lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        (out.parent / "build.log").write_text("\n".join(logs))
        os.replace(lib, out)  # atomic: a concurrent process never sees half a file


def library_path() -> Path:
    """Where the shared library of the present sources is (or will be) built."""
    return BUILD_ROOT / _sources_hash() / "librepro_kernels.so"


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _LIB
    if _LIB is None:
        out = library_path()
        if not out.is_file():
            _build(out)
        lib = ctypes.CDLL(str(out))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of card `index`."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def dtype_code(t: torch.Tensor, name: str) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {t.dtype} not supported by the kernel")
    return DTYPE_CODES[t.dtype]


ALIGN = 16  # bytes: TMA maps and cp.async copies need aligned bases and strides


def row_strides(shape: Sequence[int], strides: Sequence[int]) -> Tuple[int, int, int]:
    """(batch, seq, head) element strides of a (B, S, heads, dh) tensor, with
    the stride of each size-1 axis replaced by the contiguous one: it is
    never stepped, but the kernels' alignment rule still reads it."""
    out = []
    inner_stride, inner_size = 1, shape[3]  # the dh axis
    for axis in (2, 1, 0):
        s = strides[axis] if shape[axis] > 1 else inner_stride * inner_size
        out.append(s)
        inner_stride, inner_size = s, shape[axis]
    sh, ss, sb = out
    return sb, ss, sh


def check_aligned(what: str, data_ptr: int, strides: Sequence[int], itemsize: int) -> None:
    """Raise unless the base pointer and every stride (elements, times
    `itemsize` bytes) are multiples of 16 bytes."""
    if data_ptr % ALIGN or any((s * itemsize) % ALIGN for s in strides):
        raise ValueError(
            f"{what} is not 16-byte aligned (base pointer {data_ptr:#x}, strides "
            f"{tuple(strides)} x {itemsize} bytes)"
        )


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise where a gradient is being recorded through `tensors`: a kernel's
    output is a fresh tensor with no `grad_fn`, so autograd would drop the
    gradient silently. `ops.rmsnorm` is the differentiable entry."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} kernel: an input requires grad and the kernel has no autograd "
            "node; call it under torch.no_grad() (rmsnorm: use ops.rmsnorm)"
        )
