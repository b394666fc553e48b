"""Split-K decode without a card: the split count, the split-and-merge rule
(`ref.decode_attention_split`, the kernel's arithmetic written out plainly)
against `ref.decode_attention` and the Pallas decode kernel in interpret
mode, the lse mode and the merge of (output, lse) parts of a cache cut by
slots (`ref.merge_decode_parts`, the sharded decode's merge across ranks),
and the 16-byte alignment rule of the kernels' TMA and cp.async copies. f32
throughout, at `TOLS["float32"]` (2e-5, as tests/test_kernels.py).
"""

import math

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    MAX_SPLITS, TILE, decode_splits)

TOL = 2e-5


@pytest.fixture(scope="module")
def pallas():
    jax = pytest.importorskip("jax")
    from repro.kernels.decode_attention import decode_attention

    return types.SimpleNamespace(jnp=jax.numpy, decode=decode_attention)


def randn(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


class TestDecodeSplits:
    @pytest.mark.parametrize("B,K,Sc,n_sm,want", [
        (1, 32, 576, 132, 5),  # 2, 2, 2, 2, 1 tiles: 160 CTAs
        (8, 32, 576, 132, 1),  # the ICC batch already fills the card
        (4, 32, 576, 132, 2),  # 128 CTAs < 132: 2 splits of 5 + 4 tiles
        (2, 32, 576, 132, 3),
        (1, 8, 4096, 132, 16),
        (1, 1, 100000, 132, 63),  # capped at MAX_SPLITS, then whole tiles: 63 x 25
        (1, 32, 40, 132, 1),  # one tile: nothing to split
    ])
    def test_count(self, B, K, Sc, n_sm, want):
        assert decode_splits(B, K, Sc, n_sm) == want

    @pytest.mark.parametrize("B,K", [(1, 1), (1, 8), (1, 32), (2, 32), (3, 5), (8, 32)])
    @pytest.mark.parametrize("Sc", [1, 63, 64, 65, 576, 1000, 4096])
    def test_whole_tiles_never_more_splits_than_tiles(self, B, K, Sc):
        n_tiles = -(-Sc // TILE)
        splits = decode_splits(B, K, Sc, 132)
        assert 1 <= splits <= min(n_tiles, MAX_SPLITS)
        if B * K >= 132:
            assert splits == 1
        per = -(-n_tiles // splits)  # tiles per split, as the kernel walks them
        ranges = [(s * per, min((s + 1) * per, n_tiles)) for s in range(splits)]
        assert ranges[0][0] == 0 and ranges[-1][1] == n_tiles
        assert all(lo < hi for lo, hi in ranges)  # no split is empty
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))  # contiguous
        assert B * K * splits < 132 + B * K  # about one wave, no more


def cache(B, H, K, Sc, dh, lengths):
    """q (B,H,dh), k/v (B,Sc,K,dh), kv_pos rows 0..n-1 then empty, pos = n-1."""
    q, k, v = randn(0, (B, H, dh)), randn(1, (B, Sc, K, dh)), randn(2, (B, Sc, K, dh))
    kv_pos = np.full((B, Sc), -1, np.int32)
    for b, n in enumerate(lengths):
        kv_pos[b, :n] = np.arange(n)
    pos = np.asarray([max(n - 1, 0) for n in lengths], np.int32)
    return q, k, v, kv_pos, pos


def ring_cache(Sc, p, H=4, K=2, dh=16):
    """Positions 0..p written at slot x % Sc (a ring buffer), batch 1."""
    q, k, v = randn(0, (1, H, dh)), randn(1, (1, Sc, K, dh)), randn(2, (1, Sc, K, dh))
    kv_pos = np.full((1, Sc), -1, np.int32)
    for x in range(p + 1):
        kv_pos[0, x % Sc] = x
    return q, k, v, kv_pos, np.asarray([p], np.int32)


CASES = {  # name: (inputs, window)
    "two_rows": (cache(2, 8, 2, 576, 32, [576, 300]), 0),
    "window": (cache(2, 8, 2, 576, 32, [576, 300]), 100),
    "empty_splits": (cache(1, 4, 4, 576, 16, [40]), 0),  # only the first tile is valid
    "all_empty_row": (cache(2, 4, 2, 576, 16, [500, 0]), 0),
    "ring": (ring_cache(576, 700), 200),  # the window wraps across split boundaries
}


class TestSplitMergeRule:
    @pytest.mark.parametrize("splits", [1, 2, 5, 9])
    @pytest.mark.parametrize("case", sorted(CASES))
    def test_against_plain(self, case, splits):
        (q, k, v, kv_pos, pos), window = CASES[case]
        args = [torch.from_numpy(a) for a in (q, k, v, kv_pos, pos)]
        got = ref.decode_attention_split(*args, window=window, splits=splits)
        want = ref.decode_attention(*args, window=window)
        torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
        for b in range(q.shape[0]):
            if (kv_pos[b] < 0).all():
                assert float(got[b].abs().max()) == 0.0

    @pytest.mark.parametrize("splits", [1, 2, 5, 9])
    @pytest.mark.parametrize("case", sorted(CASES))
    def test_against_pallas(self, pallas, case, splits):
        (q, k, v, kv_pos, pos), window = CASES[case]
        a = pallas.jnp.asarray
        # the Pallas kernel takes the cache as (B, K, Sc, dh)
        o = pallas.decode(a(q), a(k.transpose(0, 2, 1, 3)), a(v.transpose(0, 2, 1, 3)),
                          a(kv_pos), a(pos), window=window, block_k=64, interpret=True)
        got = ref.decode_attention_split(*(torch.from_numpy(x) for x in (q, k, v, kv_pos, pos)),
                                         window=window, splits=splits)
        np.testing.assert_allclose(got.numpy(), np.asarray(o, np.float32), rtol=TOL, atol=TOL)


def lse_cache(G, window):
    """Rows of a 96-slot cache, K = 2, dh 16: row 0 positions 0..95 in order,
    row 1 positions 0..19 in slots 60..79 only (no valid slot before slot
    60), row 2 empty (dead in every part)."""
    B, K, Sc, dh = 3, 2, 96, 16
    q, k, v = randn(3, (B, K * G, dh)), randn(4, (B, Sc, K, dh)), randn(5, (B, Sc, K, dh))
    kv_pos = np.full((B, Sc), -1, np.int32)
    kv_pos[0] = np.arange(Sc)
    kv_pos[1, 60:80] = np.arange(20)
    pos = np.asarray([Sc - 1, 19, 0], np.int32)
    return [torch.from_numpy(a) for a in (q, k, v, kv_pos, pos)], window


def cut(args, parts):
    """(q, and each part's k, v, kv_pos, pos): the slots cut into `parts`
    equal ranges, as a cache's slots are sharded over `parts` ranks."""
    q, k, v, kv_pos, pos = args
    n = k.shape[1] // parts
    return [(q, k[:, i * n:(i + 1) * n], v[:, i * n:(i + 1) * n], kv_pos[:, i * n:(i + 1) * n],
             pos) for i in range(parts)]


LSE_CASES = [pytest.param(G, window, id=f"G{G}-window{window}")
             for G in (1, 4, 16) for window in (0, 24)]


class TestLseMerge:
    @pytest.mark.parametrize("parts", [2, 3])
    @pytest.mark.parametrize("G,window", LSE_CASES)
    def test_parts_merged_equal_whole(self, G, window, parts):
        args, window = lse_cache(G, window)
        got = [ref.decode_attention(*a, window=window, return_lse=True) for a in cut(args, parts)]
        merged = ref.merge_decode_parts([o for o, _ in got], [lse for _, lse in got])
        whole, whole_lse = ref.decode_attention(*args, window=window, return_lse=True)
        assert merged.dtype == whole.dtype == torch.float32
        torch.testing.assert_close(merged, ref.decode_attention(*args, window=window),
                                   rtol=TOL, atol=TOL)
        torch.testing.assert_close(whole, merged, rtol=TOL, atol=TOL)
        # the parts' lse merged the same way: log of the summed exp
        lses = torch.stack([lse for _, lse in got])
        torch.testing.assert_close(torch.logsumexp(lses, dim=0), whole_lse, rtol=TOL, atol=TOL)

    @pytest.mark.parametrize("G,window", LSE_CASES)
    def test_lse_equals_logsumexp_of_valid_scores(self, G, window):
        (q, k, v, kv_pos, pos), window = lse_cache(G, window)
        B, H, dh = q.shape
        K = k.shape[2]
        s = torch.einsum("bkgd,bskd->bkgs", q.reshape(B, K, H // K, dh), k) / math.sqrt(dh)
        ok = (kv_pos >= 0) & (kv_pos <= pos[:, None])
        if window:
            ok &= kv_pos > pos[:, None] - window
        want = torch.logsumexp(s.masked_fill(~ok[:, None, None, :], -math.inf), dim=-1)
        _, lse = ref.decode_attention(q, k, v, kv_pos, pos, window=window, return_lse=True)
        torch.testing.assert_close(lse, want.reshape(B, H), rtol=TOL, atol=TOL)
        assert torch.isneginf(lse[2]).all() and torch.isfinite(lse[:2]).all()

    @pytest.mark.parametrize("parts", [2, 3])
    @pytest.mark.parametrize("G,window", LSE_CASES)
    def test_dead_rows_give_zero(self, G, window, parts):
        """Row 2 has no valid slot in any part: 0, never NaN. Row 1's first
        part holds none of its slots: that part's lse is -inf, its weight 0."""
        args, window = lse_cache(G, window)
        got = [ref.decode_attention(*a, window=window, return_lse=True) for a in cut(args, parts)]
        merged = ref.merge_decode_parts([o for o, _ in got], [lse for _, lse in got])
        assert not torch.isnan(merged).any()
        assert float(merged[2].abs().max()) == 0.0
        for o, lse in got:
            assert torch.isneginf(lse[2]).all() and float(o[2].abs().max()) == 0.0
        o0, lse0 = got[0]
        assert torch.isneginf(lse0[1]).all() and float(o0[1].abs().max()) == 0.0
        assert float(merged[1].abs().max()) > 0.0

    def test_one_part_weight_is_exactly_one(self):
        """One part (a mesh dim of size 1): the merge returns its output bit
        for bit, so a one-rank mesh's logits equal the unsharded run's."""
        args, _ = lse_cache(4, 0)
        o, lse = ref.decode_attention(*args, return_lse=True)
        assert torch.equal(ref.merge_weights(lse, lse)[:2], torch.ones_like(lse[:2]))
        assert torch.equal(ref.merge_decode_parts([o], [lse]), o)


class TestAlignmentRule:
    def test_row_strides_normalises_size_one_axes(self):
        # (B=1, S, H, dh): the batch stride is never stepped; use the contiguous one
        assert _build.row_strides((1, 15, 32, 128), (7, 4096, 128, 1)) == (61440, 4096, 128)
        assert _build.row_strides((2, 15, 1, 64), (960, 64, 3, 1)) == (960, 64, 64)
        assert _build.row_strides((2, 8, 4, 16), (999, 64, 16, 1)) == (999, 64, 16)

    @pytest.mark.parametrize("ptr,strides,itemsize", [
        (0x7F0000000000, (61440, 4096, 128), 2),  # the model layout, bf16
        (0x7F0000000010, (3 * 4096, 3 * 128, 128), 2),  # q of a fused qkv projection
        (0x7F0000000000, (2048, 256, 16), 2),  # dh 16
        (0x7F0000000000, (1000, 100, 4), 4),  # f32, strides of 16 bytes
    ])
    def test_aligned_passes(self, ptr, strides, itemsize):
        _build.check_aligned("t", ptr, strides, itemsize)

    @pytest.mark.parametrize("ptr,strides,itemsize", [
        (0x7F0000000002, (61440, 4096, 128), 2),  # base pointer 2 bytes off
        (0x7F0000000000, (61440, 4100, 128), 2),  # seq stride of 8200 bytes
        (0x7F0000000000, (61440, 4096, 129), 2),  # head stride of 258 bytes
        (0x7F0000000000, (61441, 4096, 128), 2),  # batch stride
        (0x7F0000000000, (1000, 100, 3), 4),  # f32, 12-byte stride
    ])
    def test_misaligned_raises(self, ptr, strides, itemsize):
        with pytest.raises(ValueError, match="16-byte aligned"):
            _build.check_aligned("t", ptr, strides, itemsize)

    def test_model_layout_tensors_are_aligned(self):
        """What the model hands the kernels passes the rule."""
        x = torch.zeros((1, 15, 3, 32, 128), dtype=torch.bfloat16)
        for t in (x[:, :, 0], x[:, :, 1], torch.zeros((2, 576, 32, 128), dtype=torch.bfloat16)):
            _build.check_aligned("t", t.data_ptr(), _build.row_strides(t.shape, t.stride()),
                                 t.element_size())
