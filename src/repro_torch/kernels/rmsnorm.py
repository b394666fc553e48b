"""RMSNorm on the card: wrappers over `csrc/rmsnorm.cu`.

`rmsnorm` replaces the Pallas kernel `repro/kernels/rmsnorm.py:rmsnorm`; the
plain version is `ref.rmsnorm`. One read and one write per element:
latency-bound at the decode step's few rows, bytes-bound at a long prompt's
many. `rmsnorm_plan` chooses the kernel's CTA shape from the row count.

`rmsnorm_bwd` is its gradient (plain version `ref.rmsnorm_bwd`): one
cooperative launch in which each CTA streams a contiguous block of rows
through a ring of shared-memory stages, writes dx and keeps its f64 partial
of dgamma in registers, and after a grid-wide barrier sums a slice of
columns over every CTA's partial. `rmsnorm_bwd_plan` chooses the CTA's
threads, the ring's depth and the grid. Neither wrapper records a gradient:
`ops.RMSNormFn` ties the two together for autograd.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from . import _build

__all__ = ["rmsnorm", "rmsnorm_bwd", "rmsnorm_plan", "rmsnorm_bwd_plan", "vector_path", "launch",
           "launch_bwd", "max_threads", "bwd_max_threads", "bwd_smem", "bwd_row_block",
           "bwd_col_groups", "VPTS", "BWD_VPTS"]

VEC_BYTES = 16  # one load or store per thread and vector
VPTS = (1, 2, 4, 8, 16)  # vectors per thread the kernel is built for
# Up to this many rows per SM, one CTA per row (latency); above it, several
# rows per CTA and a grid that walks the rows (bytes). Chosen from times on
# an H100 by `chip_smoke.py --rmsnorm-sweep` (PERF.md, section 6).
FEW_ROWS_PER_SM = 4
FEW_THREADS = 256  # most threads a row gets in the few-rows regime
MANY_THREADS = 128  # most threads a row gets in the many-rows regime
MANY_CTA = 256  # threads per CTA in the many-rows regime
# The backward (`csrc/rmsnorm.cu`, kept equal there). Its caps, chosen from
# times on an H100 by `chip_smoke.py --rmsnorm-bwd-sweep` (PERF.md, section
# 6): the most threads a CTA gets where the row allows it, the most ring
# stages, and the most CTAs an SM holds (a third adds a partial of dgamma
# to sum and no bandwidth).
BWD_THREADS = 256
BWD_STAGES = 3
BWD_RESIDENT = 2
BWD_MAX_D = 16384
BWD_MAX_STAGES = 8  # the kernel's mbarriers, one a stage
BWD_MAX_ELEMS = 32  # f64 partials of dgamma a thread holds in registers
BWD_VPTS = {True: (1, 2, 4, 8), False: (1, 2, 4, 8, 16, 32)}  # built, by path
# Shared memory on an H100 (sm_90): what one block may opt into, what an SM
# holds, what each resident block reserves beside its own; the kernel's
# static part (mbarriers, per-warp sums) is 1088 bytes, counted here with room.
BLOCK_SMEM = 232448
SM_SMEM = 233472
BLOCK_RESERVED_SMEM = 1024
BWD_STATIC_SMEM = 2048


def max_threads(vpt: int, vec: bool = True) -> int:
    """The most threads a CTA may have at `vpt` vectors per thread, as the
    kernel's `__launch_bounds__` (`csrc/rmsnorm.cu:max_threads`): x and
    gamma vectors live in registers, so deep threads need a smaller CTA."""
    return 1024 if not vec or vpt <= 4 else 4096 // vpt


@functools.lru_cache(maxsize=4096)  # one entry per (n, d, dtype) a process sees
def rmsnorm_plan(n: int, d: int, itemsize: int, n_sm: int, *,
                 vec: bool = True) -> Tuple[int, int, int]:
    """(rows per CTA, threads per row, vectors per thread) for n rows of d
    elements of `itemsize` bytes on a card of `n_sm` SMs. A vector is 16
    bytes on the vector path and one element on the scalar one (`vec`).

    Threads per row never outnumber the row's vectors, and rows narrower
    than a warp share one. Few rows get one CTA each; many rows are packed
    several to a CTA."""
    width = VEC_BYTES // itemsize if vec else 1
    nvec = -(-d // width)
    few = n <= FEW_ROWS_PER_SM * n_sm
    cap = FEW_THREADS if few else MANY_THREADS

    def threads(vpt: int) -> int:
        if nvec <= 32:  # a power of two of lanes, no more than the row's vectors
            return 1 << (nvec.bit_length() - 1)
        return (-(-nvec // vpt) + 31) // 32 * 32

    def fits(vpt: int, limit: int) -> bool:
        tpr = threads(vpt)
        return tpr * vpt >= nvec and tpr <= nvec and tpr <= min(limit, max_threads(vpt, vec))

    # the fewest vectors per thread under the regime's cap; a row too wide
    # for the cap takes the deepest threads instead
    vpt = next((v for v in VPTS if fits(v, cap)), VPTS[-1])
    if not fits(vpt, 1024):
        raise ValueError(f"rmsnorm kernel: a row of d={d} does not fit one CTA's registers")
    tpr = threads(vpt)
    if few:
        rows = max(1, 32 // tpr)
    else:  # MANY_CTA threads, and at least two rows where the bounds allow
        rows = max(1, min(max(MANY_CTA, 2 * tpr), max_threads(vpt, vec)) // tpr)
    return rows, tpr, vpt


def vector_path(rows: torch.Tensor, gamma: torch.Tensor, out: torch.Tensor) -> bool:
    """Whether the kernel may read and write in 16-byte vectors: d and the
    row stride whole vectors, x, gamma and out 16-byte aligned."""
    width = VEC_BYTES // rows.element_size()
    return (rows.shape[1] % width == 0 and rows.stride(0) % width == 0
            and all(t.data_ptr() % VEC_BYTES == 0 for t in (rows, gamma, out)))


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x (..., d) on the card, its rows a view of one stride (a slice such
    as x[:, -1] is fine); gamma (d,) of x's dtype or f32. Returns a
    contiguous tensor of x's shape and dtype."""
    _build.refuse_grad("rmsnorm", x, gamma)
    if not (x.is_cuda and gamma.is_cuda):
        raise ValueError("rmsnorm kernel: tensors must be on the card")
    d = x.shape[-1]
    if gamma.shape != (d,):
        raise ValueError(f"rmsnorm kernel: gamma {tuple(gamma.shape)} for d={d}")
    if x.stride(-1) != 1 or not gamma.is_contiguous():
        raise ValueError("rmsnorm kernel: the d axis and gamma must be contiguous")
    rows = x.view(-1, d)  # raises where the rows are not one stride apart
    if gamma.dtype not in (x.dtype, torch.float32):
        raise TypeError(f"rmsnorm kernel: gamma {gamma.dtype} with x {x.dtype}")
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if rows.shape[0] == 0:
        return out
    vec = vector_path(rows, gamma, out)
    plan = rmsnorm_plan(rows.shape[0], d, x.element_size(), _build.sm_count(x.device.index),
                        vec=vec)
    launch(rows, gamma, out, eps, plan, vec)
    return out


def launch(rows: torch.Tensor, gamma: torch.Tensor, out: torch.Tensor, eps: float,
           plan: Tuple[int, int, int], vec: bool) -> None:
    """Launch the kernel over `rows` (n, d) with an explicit plan; `rmsnorm`
    passes `rmsnorm_plan`'s. The kernel refuses a plan that does not cover d."""
    n, d = rows.shape
    err = _build.library().rmsnorm_fwd(
        rows.data_ptr(), gamma.data_ptr(), out.data_ptr(), n, d, rows.stride(0), float(eps),
        _build.dtype_code(rows, "rmsnorm"), _build.dtype_code(gamma, "rmsnorm"), *plan,
        int(vec), _build.stream_of(rows),
    )
    _build.check(err, "rmsnorm")
    _build.LAUNCHES["rmsnorm"] += 1


def bwd_max_threads(elems: int) -> int:
    """The most threads a backward CTA may have at `elems` elements per
    thread, as the kernel's `__launch_bounds__` (`csrc/rmsnorm.cu:
    bwd_max_threads`): 64 registers a thread at 1024, 128 at 512."""
    return 1024 if elems <= 8 else 512


def bwd_smem(d: int, itemsize: int, threads: int, stages: int, gamma_itemsize: int = 4) -> int:
    """Dynamic shared memory of a backward launch, as the kernel's launch
    computes it: the ring (x and dy rows per stage; the scalar
    path's one stage, 0 in its plan) and gamma (as it is on the vector path,
    as f32 on the scalar), or the column sums' buffer (8 bytes a thread) if
    that is larger."""
    return max(max(stages, 1) * 2 * d * itemsize + d * gamma_itemsize, 8 * threads)


def bwd_resident(threads: int, elems: int, smem: int) -> int:
    """Backward CTAs an SM holds at once: by threads, by registers at the
    launch bounds' cap, and by shared memory, at most BWD_RESIDENT. It never
    exceeds what `cudaOccupancyMaxActiveBlocksPerMultiprocessor` finds,
    which the kernel's launch checks."""
    by_threads = 2048 // threads
    by_registers = bwd_max_threads(elems) // threads
    by_smem = SM_SMEM // (smem + BWD_STATIC_SMEM + BLOCK_RESERVED_SMEM)
    return max(0, min(by_threads, by_registers, by_smem, BWD_RESIDENT))


@functools.lru_cache(maxsize=4096)  # one entry per (n, d, dtype) a process sees
def rmsnorm_bwd_plan(n: int, d: int, itemsize: int, n_sm: int, *, vec: bool = True,
                     gamma_itemsize: int = 0, max_threads: int = BWD_THREADS,
                     max_stages: int = BWD_STAGES) -> Tuple[int, int, int, int]:
    """(threads per CTA, vectors per thread, ring stages, CTAs) of the
    backward for n rows of d elements of `itemsize` bytes on a card of
    `n_sm` SMs, gamma's elements `gamma_itemsize` bytes (0: x's). A vector is
    16 bytes on the vector path and one element on the scalar one (`vec`),
    which has no ring (0 stages) and keeps gamma as f32.

    The fewest vectors per thread under `max_threads` threads (a row too
    wide for that takes the widest CTA its registers allow), the most
    stages up to `max_stages` that fit a block's shared memory, and as many
    CTAs as are resident, at most one per row."""
    if not 1 <= d <= BWD_MAX_D:
        raise ValueError(f"rmsnorm_bwd kernel: d={d} not in [1, {BWD_MAX_D}]")
    width = VEC_BYTES // itemsize if vec else 1
    nvec = -(-d // width)

    def threads(vpt: int) -> int:
        return (-(-nvec // vpt) + 31) // 32 * 32

    fit = [v for v in BWD_VPTS[vec]
           if v * width <= BWD_MAX_ELEMS and threads(v) <= bwd_max_threads(v * width)]
    vpt = next((v for v in fit if threads(v) <= max_threads), fit[-1])
    nt = threads(vpt)
    g_item = (gamma_itemsize or itemsize) if vec else 4
    room = BLOCK_SMEM - BWD_STATIC_SMEM - d * g_item
    stages = min(max_stages, BWD_MAX_STAGES, room // (2 * d * itemsize))
    if stages < 1:
        raise ValueError(f"rmsnorm_bwd kernel: a row of d={d} does not fit shared memory")
    if not vec:
        stages = 0  # one stage, filled by the threads: no ring
    resident = bwd_resident(nt, vpt * width, bwd_smem(d, itemsize, nt, stages, g_item))
    return nt, vpt, stages, min(n, resident * n_sm)


def bwd_row_block(b: int, n: int, n_cta: int) -> Tuple[int, int]:
    """(first row, rows) of CTA b: contiguous blocks in order, sizes
    differing by at most one, as the kernel takes them."""
    q, r = divmod(n, n_cta)
    return b * q + min(b, r), q + (b < r)


def bwd_col_groups(d: int, n_cta: int, threads: int) -> Tuple[int, int]:
    """(columns a CTA sums at once, row groups) of the kernel's sum over the
    CTAs' partials: thread t takes column t % cw of the chunk and partials
    t // cw, t // cw + groups, ... in order; the groups' sums are then added
    in order. cw is the power of two up to 32 that covers the widest slice
    of columns a CTA owns."""
    widest = -(-d // n_cta)
    cw = 1
    while cw < widest and cw < 32:
        cw *= 2
    return cw, threads // cw


def rmsnorm_bwd(x: torch.Tensor, gamma: torch.Tensor, dy: torch.Tensor,
                eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradient of `rmsnorm(x, gamma, eps)` for the output's gradient dy
    (x's shape): (dx, contiguous, x's shape and dtype; dgamma, gamma's
    dtype). x's rows a view of one stride, as the forward takes them."""
    _build.refuse_grad("rmsnorm_bwd", x, gamma, dy)
    if not (x.is_cuda and gamma.is_cuda and dy.is_cuda):
        raise ValueError("rmsnorm_bwd kernel: tensors must be on the card")
    d = x.shape[-1]
    if gamma.shape != (d,) or dy.shape != x.shape:
        raise ValueError(f"rmsnorm_bwd kernel: x {tuple(x.shape)}, gamma "
                         f"{tuple(gamma.shape)}, dy {tuple(dy.shape)}")
    if not 1 <= d <= BWD_MAX_D:
        raise ValueError(f"rmsnorm_bwd kernel: d={d} not in [1, {BWD_MAX_D}]")
    if x.stride(-1) != 1 or not gamma.is_contiguous():
        raise ValueError("rmsnorm_bwd kernel: the d axis and gamma must be contiguous")
    if dy.dtype != x.dtype or gamma.dtype not in (x.dtype, torch.float32):
        raise TypeError(f"rmsnorm_bwd kernel: x {x.dtype}, dy {dy.dtype}, gamma {gamma.dtype}")
    rows = x.view(-1, d)  # raises where the rows are not one stride apart
    dy_rows = dy.contiguous().view(-1, d)  # an expanded or permuted gradient is copied
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if rows.shape[0] == 0:
        return dx, torch.zeros_like(gamma)
    dgamma = torch.empty_like(gamma)
    vec = vector_path(rows, gamma, dx) and dy_rows.data_ptr() % VEC_BYTES == 0
    plan = rmsnorm_bwd_plan(rows.shape[0], d, x.element_size(), _build.sm_count(x.device.index),
                            vec=vec, gamma_itemsize=gamma.element_size())
    launch_bwd(rows, gamma, dy_rows, dx.view(-1, d), dgamma, eps, plan, vec)
    return dx, dgamma


def launch_bwd(rows: torch.Tensor, gamma: torch.Tensor, dy_rows: torch.Tensor,
               dx_rows: torch.Tensor, dgamma: torch.Tensor, eps: float,
               plan: Tuple[int, int, int, int], vec: bool) -> None:
    """Launch the backward over `rows` and `dy_rows` (n, d) into `dx_rows`
    (contiguous) and `dgamma` with an explicit plan; `rmsnorm_bwd` passes
    `rmsnorm_bwd_plan`'s. The launch refuses a plan that does not cover d,
    needs more shared memory than a block has or more CTAs than the card
    holds at once: that raises, nothing falls back."""
    n, d = rows.shape
    ws = torch.empty((plan[3], d), dtype=torch.float64, device=rows.device)
    err = _build.library().rmsnorm_bwd(
        rows.data_ptr(), gamma.data_ptr(), dy_rows.data_ptr(), dx_rows.data_ptr(),
        dgamma.data_ptr(), ws.data_ptr(), n, d, rows.stride(0), dy_rows.stride(0), float(eps),
        _build.dtype_code(rows, "rmsnorm_bwd"), _build.dtype_code(gamma, "rmsnorm_bwd"), *plan,
        int(vec), _build.stream_of(rows),
    )
    _build.check(err, "rmsnorm_bwd")
    _build.LAUNCHES["rmsnorm_bwd"] += 1
