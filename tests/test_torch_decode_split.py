"""Split-K decode without a card: the split count, the split-and-merge rule
(`ref.decode_attention_split`, the kernel's arithmetic written out plainly)
against `ref.decode_attention` and the Pallas decode kernel in interpret
mode, and the 16-byte alignment rule of the kernels' TMA and cp.async
copies. f32 throughout, at `TOLS["float32"]` (2e-5, as tests/test_kernels.py).
"""

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
