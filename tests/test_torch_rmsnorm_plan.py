"""rmsnorm's CTA shape without a card: `rmsnorm_plan` covers every row
exactly, stays inside the kernel's launch bounds and takes one CTA per row
for few rows and several rows per CTA for many; `vector_path` sends
misaligned or ragged data to the scalar instantiation.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.rmsnorm import (  # noqa: E402
    FEW_ROWS_PER_SM, VEC_BYTES, VPTS, max_threads, rmsnorm_plan, vector_path)

N_SM = 132  # an H100 SXM


class TestPlan:
    @pytest.mark.parametrize("n,d,itemsize,want", [
        (8, 4096, 2, (1, 256, 2)),  # decode step: one CTA of 8 warps per row
        (15, 4096, 2, (1, 256, 2)),  # Table-I prompt
        (512, 4096, 2, (1, 256, 2)),  # 512-token prompt: still <= 4 rows per SM
        (529, 4096, 2, (2, 128, 4)),  # many rows: 2 rows of 4 warps per CTA
        (8192, 4096, 2, (2, 128, 4)),  # bytes-bound
        (8, 4096, 4, (1, 256, 4)),  # f32
        (1, 37, 2, (8, 4, 2)),  # narrow rows share a warp
    ])
    def test_main_path(self, n, d, itemsize, want):
        assert rmsnorm_plan(n, d, itemsize, N_SM) == want

    @pytest.mark.parametrize("vec", [True, False])
    @pytest.mark.parametrize("itemsize", [2, 4])
    @pytest.mark.parametrize("d", [64, 128, 4096, 5120, 8192, 11008])
    @pytest.mark.parametrize("n", [1, 8, 15, 131, 132, 133, 512, 8192])
    def test_covers_row_within_bounds(self, n, d, itemsize, vec):
        rows, tpr, vpt = rmsnorm_plan(n, d, itemsize, N_SM, vec=vec)
        width = VEC_BYTES // itemsize if vec else 1
        nvec = -(-d // width)
        assert vpt in VPTS
        assert tpr * vpt * width >= d
        assert tpr <= nvec  # no thread past the row
        threads = rows * tpr
        assert threads % 32 == 0 and threads <= max_threads(vpt, vec) <= 1024
        assert (32 % tpr == 0) if tpr < 32 else (tpr % 32 == 0)  # a warp holds whole rows
        # the kernel's mapping: vector j * tpr + t of the row for thread t
        owned = np.add.outer(np.arange(vpt) * tpr, np.arange(tpr)).ravel()
        owned = owned[owned < nvec]
        assert np.array_equal(np.sort(owned), np.arange(nvec))  # each vector once
        if n <= FEW_ROWS_PER_SM * N_SM:  # few rows: one CTA per row (one warp if narrower)
            assert rows == max(1, 32 // tpr)
        else:  # many rows: several per CTA, unless one row fills the CTA's registers
            assert rows > 1 or 2 * tpr > max_threads(vpt, vec)

    def test_regime_changes_at_the_threshold(self):
        edge = FEW_ROWS_PER_SM * N_SM
        assert rmsnorm_plan(edge, 4096, 2, N_SM)[0] == 1
        assert rmsnorm_plan(edge + 1, 4096, 2, N_SM)[0] > 1

    @pytest.mark.parametrize("d,itemsize,vec", [(65536, 2, True), (32768, 4, True),
                                                (20000, 2, False)])
    def test_row_too_wide_raises(self, d, itemsize, vec):
        with pytest.raises(ValueError, match="does not fit"):
            rmsnorm_plan(8, d, itemsize, N_SM, vec=vec)


class TestVectorPath:
    d = 4096

    def test_aligned_rows_take_vectors(self):
        x = torch.zeros((8, self.d), dtype=torch.bfloat16)
        assert vector_path(x, torch.ones(self.d, dtype=torch.bfloat16), torch.empty_like(x))
        assert vector_path(x, torch.ones(self.d), torch.empty_like(x))  # f32 gamma

    def test_last_token_view_takes_vectors(self):
        """x[:, -1] of (B, S, d), as the final norm reads it."""
        x = torch.zeros((4, 15, self.d), dtype=torch.bfloat16)[:, -1]
        assert vector_path(x, torch.ones(self.d, dtype=torch.bfloat16),
                           torch.empty(x.shape, dtype=x.dtype))

    @pytest.mark.parametrize("gdt", [torch.float32, torch.bfloat16])
    def test_misaligned_gamma_takes_scalars(self, gdt):
        x = torch.zeros((8, self.d), dtype=torch.bfloat16)
        g = torch.ones(self.d + 1, dtype=gdt)[1:]
        assert g.data_ptr() % VEC_BYTES != 0
        assert not vector_path(x, g, torch.empty_like(x))

    def test_ragged_rows_take_scalars(self):
        g = torch.ones(self.d, dtype=torch.bfloat16)
        apart = torch.zeros((8, self.d + 1), dtype=torch.bfloat16)[:, :self.d]
        assert not vector_path(apart, g, torch.empty(apart.shape, dtype=apart.dtype))
        narrow = torch.zeros((15, 37), dtype=torch.bfloat16)
        assert not vector_path(narrow, torch.ones(37, dtype=torch.bfloat16),
                               torch.empty_like(narrow))
