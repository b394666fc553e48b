"""rmsnorm's CTA shape without a card: `rmsnorm_plan` covers every row
exactly, stays inside the kernel's launch bounds and takes one CTA per row
for few rows and several rows per CTA for many; `vector_path` sends
misaligned or ragged data to the scalar instantiation. The backward's
`rmsnorm_bwd_plan` covers every width the port trains or serves inside a
block's shared memory and the launch bounds, its row blocks partition the
rows in order, and a numpy model of the kernel's summation order of dgamma
(contiguous row blocks, then row groups of CTAs) agrees with the plain
version.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.rmsnorm import (  # noqa: E402
    BLOCK_SMEM, BWD_MAX_ELEMS, BWD_MAX_STAGES, BWD_STATIC_SMEM, BWD_VPTS, FEW_ROWS_PER_SM,
    VEC_BYTES, VPTS, bwd_col_groups, bwd_max_threads, bwd_resident, bwd_row_block, bwd_smem,
    max_threads, rmsnorm_bwd_plan, rmsnorm_plan, vector_path)

N_SM = 132  # an H100 SXM
TOLS = {"float32": 2e-5, "bfloat16": 2e-2}  # tests/test_kernels.py's
# every d_model, head and inner width the port trains or serves
BWD_WIDTHS = [128, 256, 1024, 2048, 3584, 4096, 5120, 6144, 7168, 8192, 12288, 16384]


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

    @pytest.mark.parametrize("itemsize", [4, 2])  # f32, bf16
    @pytest.mark.parametrize("d", [1024, 2048, 3584, 4096, 7168])
    def test_trained_family_widths(self, d, itemsize):
        """The training steps' 2048 rows take the many-rows plan at every
        trained width, and its threads and vectors cover each row within
        the launch bounds."""
        assert 2048 > FEW_ROWS_PER_SM * N_SM
        self.test_covers_row_within_bounds(2048, d, itemsize, vec=True)

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


class TestBackwardPlan:
    @pytest.mark.parametrize("n,d,itemsize,vec,want", [
        (2048, 4096, 2, True, (256, 2, 3, 264)),  # llama2-7b's step: 2 CTAs an SM
        (2048, 12288, 2, True, (384, 4, 3, 132)),  # mistral-large-123b: 1 an SM
        (64, 4096, 4, True, (256, 4, 3, 64)),  # a CTA a row
        (15, 37, 2, False, (64, 1, 0, 15)),  # the scalar path: no ring
    ])
    def test_main_path(self, n, d, itemsize, vec, want):
        assert rmsnorm_bwd_plan(n, d, itemsize, N_SM, vec=vec) == want

    @pytest.mark.parametrize("vec", [True, False])
    @pytest.mark.parametrize("itemsize,gamma_itemsize", [(2, 2), (2, 4), (4, 4)])
    @pytest.mark.parametrize("d", BWD_WIDTHS + [37])
    @pytest.mark.parametrize("n", [1, 64, 263, 2048, 8192])
    def test_covers_row_within_bounds(self, n, d, itemsize, gamma_itemsize, vec):
        if vec and d == 37:  # not whole 16-byte vectors: the scalar path only
            return
        threads, vpt, stages, n_cta = rmsnorm_bwd_plan(n, d, itemsize, N_SM, vec=vec,
                                                       gamma_itemsize=gamma_itemsize)
        width = VEC_BYTES // itemsize if vec else 1
        assert vpt in BWD_VPTS[vec] and vpt * width <= BWD_MAX_ELEMS
        assert threads * vpt * width >= d  # every column owned
        assert -(-d // width) > threads * (vpt - 1) or vpt == 1  # no deeper than needed
        assert threads % 32 == 0 and threads <= bwd_max_threads(vpt * width) <= 1024
        smem = bwd_smem(d, itemsize, threads, stages, gamma_itemsize if vec else 4)
        assert smem + BWD_STATIC_SMEM <= BLOCK_SMEM  # 227 KB
        if vec:
            assert 1 <= stages <= BWD_MAX_STAGES
        else:
            assert stages == 0  # no ring: rows are read from device memory
        resident = bwd_resident(threads, vpt * width, smem)
        assert resident >= 1
        assert 1 <= n_cta == min(n, resident * N_SM)

    @pytest.mark.parametrize("itemsize", [4, 2])  # f32, bf16
    @pytest.mark.parametrize("d", [1024, 2048, 3584, 4096, 7168])
    def test_trained_family_widths(self, d, itemsize):
        """The hybrid, ssm and enc-dec training steps' widths at 4 x 512
        tokens: seamless-m4t's 1024, xlstm-1.3b's 2048 and mLSTM inner 4096,
        zamba2-7b's 3584 and Mamba2 inner 7168 (not powers of two). The plan
        fits a block's shared memory, its CTAs are co-resident, every column
        is owned, and the row blocks cover each of the 2048 rows once."""
        n = 2048
        threads, vpt, stages, n_cta = rmsnorm_bwd_plan(n, d, itemsize, N_SM,
                                                       gamma_itemsize=itemsize)
        width = VEC_BYTES // itemsize
        assert threads * vpt * width >= d and threads % 32 == 0
        assert threads <= bwd_max_threads(vpt * width)
        smem = bwd_smem(d, itemsize, threads, stages, itemsize)
        assert 1 <= stages <= BWD_MAX_STAGES and smem + BWD_STATIC_SMEM <= BLOCK_SMEM
        assert 1 <= n_cta <= bwd_resident(threads, vpt * width, smem) * N_SM
        blocks = [bwd_row_block(b, n, n_cta) for b in range(n_cta)]
        rows = np.concatenate([np.arange(r0, r0 + c) for r0, c in blocks])
        assert np.array_equal(rows, np.arange(n))

    @pytest.mark.parametrize("d,itemsize,gamma_itemsize", [(4096, 2, 2), (12288, 2, 2),
                                                           (12288, 2, 4), (16384, 4, 4)])
    def test_ring_fills_shared_memory_up_to_its_cap(self, d, itemsize, gamma_itemsize):
        """The most stages up to the cap: one more would not fit 227 KB."""
        cap = BWD_MAX_STAGES
        threads, _, stages, _ = rmsnorm_bwd_plan(2048, d, itemsize, N_SM, max_stages=cap,
                                                 gamma_itemsize=gamma_itemsize)
        assert stages == cap or (bwd_smem(d, itemsize, threads, stages + 1, gamma_itemsize)
                                 + BWD_STATIC_SMEM > BLOCK_SMEM)

    @pytest.mark.parametrize("d", [0, 16385, 32768])
    @pytest.mark.parametrize("vec", [True, False])
    def test_width_out_of_range_raises(self, d, vec):
        with pytest.raises(ValueError, match="not in"):
            rmsnorm_bwd_plan(8, d, 2, N_SM, vec=vec)

    @pytest.mark.parametrize("n,n_cta", [(1, 1), (7, 7), (263, 132), (263, 64), (2048, 264),
                                         (2048, 132), (2049, 132), (8192, 264)])
    def test_row_blocks_partition_rows_in_order(self, n, n_cta):
        blocks = [bwd_row_block(b, n, n_cta) for b in range(n_cta)]
        rows = np.concatenate([np.arange(r0, r0 + c) for r0, c in blocks])
        assert np.array_equal(rows, np.arange(n))  # every row once, CTA b before b + 1
        sizes = [c for _, c in blocks]
        assert max(sizes) - min(sizes) <= 1 and min(sizes) >= 1

    @pytest.mark.parametrize("d,n_cta,threads", [(4096, 264, 256), (4096, 132, 512),
                                                 (37, 15, 64), (128, 2048, 32),
                                                 (12288, 132, 384)])
    def test_column_groups_cover_the_widest_slice(self, d, n_cta, threads):
        cw, groups = bwd_col_groups(d, n_cta, threads)
        assert cw in (1, 2, 4, 8, 16, 32) and cw * groups == threads
        assert cw >= min(32, -(-d // n_cta))


def model_dgamma(x, gamma, dy, n_cta, threads, eps=1e-5):
    """dgamma as the kernel sums it: each row's f64 terms dy xhat' (made as
    the plain version makes them), summed in order over each CTA's row
    block, then CTA b's partial into row group b % groups, each group in
    order, then the groups in order; f64 -> f32 -> gamma's dtype."""
    d = x.shape[-1]
    xf, dyf = x.float(), dy.float()
    r = torch.rsqrt((xf.double() ** 2).mean(dim=-1, keepdim=True) + eps).float()
    terms = (dyf.double() * (xf * r).to(x.dtype).double()).numpy()
    n = terms.shape[0]
    parts = []
    for b in range(n_cta):
        r0, c = bwd_row_block(b, n, n_cta)
        parts.append(np.cumsum(terms[r0:r0 + c], axis=0)[-1])  # sequential
    parts = np.stack(parts)
    _, groups = bwd_col_groups(d, n_cta, threads)
    sums = np.stack([np.cumsum(parts[g::groups], axis=0)[-1] if g < n_cta else np.zeros(d)
                     for g in range(groups)])
    total = np.cumsum(sums, axis=0)[-1]
    return torch.from_numpy(total).float().to(gamma.dtype)


class TestBackwardSummationOrder:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("n", [2048, 263])
    @pytest.mark.parametrize("n_cta", [1, 64, 132, 264])
    def test_model_matches_plain(self, n, n_cta, dtype):
        d = 4096
        n_cta = min(n, n_cta)
        rng = np.random.default_rng(n + n_cta)
        t = getattr(torch, dtype)
        x = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)).to(t)
        dy = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)).to(t)
        gamma = torch.from_numpy(1.0 + 0.1 * rng.standard_normal(d, dtype=np.float32)).to(t)
        threads = rmsnorm_bwd_plan(n, d, x.element_size(), N_SM)[0]
        got = model_dgamma(x, gamma, dy, n_cta, threads)
        want = ref.rmsnorm_bwd(x, gamma, dy)[1]
        assert got.dtype == want.dtype
        torch.testing.assert_close(got.float(), want.float(), rtol=TOLS[dtype], atol=TOLS[dtype])
