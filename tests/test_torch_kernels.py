"""The port's kernels: plain versions against the Pallas kernels (interpret
mode, as tests/test_kernels.py runs them) on the CPU, and the CUDA kernels
against their plain versions on the card (marked `cuda`, skipped without
one). Same shapes, masks and tolerances (`TOLS`) as tests/test_kernels.py.

JAX is imported only by the `pallas` fixture, so the card machine, which has
no JAX, runs the `cuda` tests with `pytest -m cuda` and skips the rest.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402

TOLS = {"float32": 2e-5, "bfloat16": 2e-2}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}
CARD_TOLS = dict(TOLS, float16=TOLS["bfloat16"])  # f16 on the card: bf16's bound

FLASH_SHAPES = [  # B, H, K, Sq, Sk, dh, bq, bk — as tests/test_kernels.py
    (1, 4, 4, 32, 32, 16, 16, 16),  # MHA
    (2, 8, 2, 48, 48, 32, 16, 16),  # GQA 4:1
    (1, 4, 1, 40, 72, 16, 16, 32),  # MQA, Sq != Sk, ragged blocks
    (1, 2, 2, 17, 33, 8, 16, 16),  # non-divisible padding
    (1, 2, 2, 20, 20, 112, 16, 16),  # zamba2-7b's dh = 3584 / 32
    (1, 2, 2, 15, 40, 112, 16, 16),  # dh 112, Sq != Sk (cross attention's shape)
]
MASKS = [(True, 0), (True, 8), (False, 0)]
OFFSET_SHAPES = [(1, 4, 4, 40, 16), (2, 8, 2, 48, 32)]  # B, H, K, S, dh: MHA, GQA 4:1
DECODE_SHAPES = [(2, 4, 2, 64, 16, 16), (1, 8, 8, 70, 32, 32),  # B, H, K, Sc, dh, bk
                 (2, 2, 2, 40, 112, 16)]  # zamba2-7b's dh


@pytest.fixture(scope="module")
def pallas():
    """The reference Pallas kernels and jnp (absent on the card machine)."""
    jax = pytest.importorskip("jax")
    from repro.kernels.decode_attention import decode_attention
    from repro.kernels.flash_attention import flash_attention
    from repro.kernels.rmsnorm import rmsnorm

    return types.SimpleNamespace(jnp=jax.numpy, flash=flash_attention,
                                 decode=decode_attention, rmsnorm=rmsnorm)


def randn(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def both(jnp, x, dtype):
    """The same values as a jnp array and a torch tensor of `dtype`."""
    return jnp.asarray(x).astype(getattr(jnp, dtype)), torch.from_numpy(x).to(TORCH[dtype])


def f32(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def decode_inputs(B, H, K, Sc, dh):
    q, k, v = randn(0, (B, H, dh)), randn(1, (B, K, Sc, dh)), randn(2, (B, K, Sc, dh))
    kv_pos = np.broadcast_to(np.arange(Sc, dtype=np.int32), (B, Sc)).copy()
    kv_pos[kv_pos >= Sc - 7] = -1  # empty tail slots
    pos = np.full((B,), Sc - 8, np.int32)
    return q, k, v, kv_pos, pos


def split_positions(B, Sc, case):
    """(kv_pos, pos, window) for the split-K decode cases."""
    kv_pos = np.full((B, Sc), -1, np.int32)
    window = 0
    if case == "ring":  # positions 0..700 written at slot p % Sc, window 200
        p = 700
        for x in range(p + 1):
            kv_pos[0, x % Sc] = x
        window = 200
        return kv_pos, np.full((B,), p, np.int32), window
    lengths = {"rows": [Sc, 0], "short": [40], "full": [Sc]}[case]
    for b, n in enumerate(lengths):
        kv_pos[b, :n] = np.arange(n)
    return kv_pos, np.asarray([max(n - 1, 0) for n in lengths], np.int32), window


class TestPlainAgainstPallas:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("B,H,K,Sq,Sk,dh,bq,bk", FLASH_SHAPES)
    def test_flash_attention(self, pallas, dtype, B, H, K, Sq, Sk, dh, bq, bk):
        qj, qt = both(pallas.jnp, randn(0, (B, H, Sq, dh)), dtype)
        kj, kt = both(pallas.jnp, randn(1, (B, K, Sk, dh)), dtype)
        vj, vt = both(pallas.jnp, randn(2, (B, K, Sk, dh)), dtype)
        tol = TOLS[dtype]
        for causal, window in MASKS:
            if causal and Sq > Sk:
                continue
            o = pallas.flash(qj, kj, vj, causal=causal, window=window,
                             block_q=bq, block_k=bk, interpret=True)
            r = ref.flash_attention(qt.transpose(1, 2), kt.transpose(1, 2),
                                    vt.transpose(1, 2), causal=causal, window=window)
            assert r.dtype == TORCH[dtype]
            np.testing.assert_allclose(f32(r.transpose(1, 2)), f32(o), rtol=tol, atol=tol)

    def test_flash_fully_masked_rows_emit_zero(self, pallas):
        """Sq > Sk with a window: rows 11.. see no key (k < 8), both give 0."""
        q, k, v = randn(0, (1, 2, 32, 16)), randn(1, (1, 2, 8, 16)), randn(2, (1, 2, 8, 16))
        a = pallas.jnp.asarray
        o = pallas.flash(a(q), a(k), a(v), causal=False, window=4, block_q=16, block_k=8,
                         interpret=True)
        r = ref.flash_attention(*(torch.from_numpy(a).transpose(1, 2) for a in (q, k, v)),
                                causal=False, window=4)
        np.testing.assert_allclose(f32(r.transpose(1, 2)), f32(o), rtol=2e-5, atol=2e-5)
        assert float(r[:, 11:].abs().max()) == 0.0

    def test_flash_kv_len_equals_truncated_keys(self):
        q, k, v = (torch.from_numpy(randn(i, (1, 12, 2, 16))) for i in range(3))
        r = ref.flash_attention(q, k, v, causal=False, kv_len=5)
        torch.testing.assert_close(
            r, ref.flash_attention(q, k[:, :5], v[:, :5], causal=False), rtol=1e-6, atol=1e-6)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("B,H,K,S,dh", OFFSET_SHAPES)
    def test_flash_q_offset_is_a_block_of_rows(self, pallas, dtype, B, H, K, S, dh):
        """A block of query rows at its offset (one rank's rows under
        context parallelism) equals those rows of the whole sequence's plain
        attention, causal and windowed, and the JAX package's
        `naive_attention` over the same positions."""
        from repro.models.attention import naive_attention

        q, k, v = randn(0, (B, S, H, dh)), randn(1, (B, S, K, dh)), randn(2, (B, S, K, dh))
        qt, kt, vt = (torch.from_numpy(a).to(TORCH[dtype]) for a in (q, k, v))
        jnp, tol = pallas.jnp, TOLS[dtype]
        for causal, window in MASKS:
            whole = ref.flash_attention(qt, kt, vt, causal=causal, window=window)
            for lo, hi in ((0, S // 2), (S // 2, S), (5, 17), (S - 3, S)):
                part = ref.flash_attention(qt[:, lo:hi], kt, vt, causal=causal, window=window,
                                           q_offset=lo)
                np.testing.assert_allclose(f32(part), f32(whole[:, lo:hi]), rtol=tol, atol=tol)
                qj = jnp.asarray(q[:, lo:hi].reshape(B, hi - lo, K, H // K, dh)).astype(
                    getattr(jnp, dtype))
                kj, vj = (jnp.asarray(a).astype(getattr(jnp, dtype)) for a in (k, v))
                pos = lambda a, b: jnp.broadcast_to(jnp.arange(a, b, dtype=jnp.int32), (B, b - a))
                o = naive_attention(qj, kj, vj, pos(lo, hi), pos(0, S), causal, window)
                np.testing.assert_allclose(f32(part), f32(o).reshape(B, hi - lo, H, dh),
                                           rtol=tol, atol=tol)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("B,H,K,Sc,dh,bk", DECODE_SHAPES)
    def test_decode_attention(self, pallas, dtype, B, H, K, Sc, dh, bk):
        q, k, v, kv_pos, pos = decode_inputs(B, H, K, Sc, dh)
        qj, qt = both(pallas.jnp, q, dtype)
        kj, kt = both(pallas.jnp, k, dtype)
        vj, vt = both(pallas.jnp, v, dtype)
        tol = TOLS[dtype]
        for window in (0, 16):
            a = pallas.jnp.asarray
            o = pallas.decode(qj, kj, vj, a(kv_pos), a(pos), window=window, block_k=bk,
                              interpret=True)
            r = ref.decode_attention(qt, kt.transpose(1, 2), vt.transpose(1, 2),
                                     torch.from_numpy(kv_pos), torch.from_numpy(pos),
                                     window=window)
            np.testing.assert_allclose(f32(r), f32(o), rtol=tol, atol=tol)

    def test_decode_ring_cache(self, pallas):
        """Out-of-order absolute positions (ring buffer) mask correctly."""
        B, H, K, Sc, dh = 1, 2, 2, 16, 8
        q, k, v = randn(0, (B, H, dh)), randn(1, (B, K, Sc, dh)), randn(2, (B, K, Sc, dh))
        kv_pos = np.asarray([[16, 17, 18, 19, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15]],
                            np.int32)
        pos = np.asarray([19], np.int32)
        a = pallas.jnp.asarray
        o = pallas.decode(a(q), a(k), a(v), a(kv_pos), a(pos), window=8, block_k=8,
                          interpret=True)
        r = ref.decode_attention(torch.from_numpy(q), torch.from_numpy(k).transpose(1, 2),
                                 torch.from_numpy(v).transpose(1, 2),
                                 torch.from_numpy(kv_pos), torch.from_numpy(pos), window=8)
        np.testing.assert_allclose(f32(r), f32(o), rtol=2e-5, atol=2e-5)

    def test_decode_all_empty_row_emits_zero(self, pallas):
        """The kernel's rule (0), not repro.kernels.ref's mean(V)."""
        B, H, K, Sc, dh = 2, 4, 2, 32, 16
        q, k, v, kv_pos, pos = decode_inputs(B, H, K, Sc, dh)
        kv_pos[1] = -1
        a = pallas.jnp.asarray
        o = pallas.decode(a(q), a(k), a(v), a(kv_pos), a(pos), block_k=16, interpret=True)
        r = ref.decode_attention(torch.from_numpy(q), torch.from_numpy(k).transpose(1, 2),
                                 torch.from_numpy(v).transpose(1, 2),
                                 torch.from_numpy(kv_pos), torch.from_numpy(pos))
        np.testing.assert_allclose(f32(r), f32(o), rtol=2e-5, atol=2e-5)
        assert float(r[1].abs().max()) == 0.0

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("shape", [(8, 128), (3, 37, 64), (1, 256), (8, 4096), (15, 4096)])
    def test_rmsnorm(self, pallas, dtype, shape):
        xj, xt = both(pallas.jnp, randn(3, shape), dtype)
        g = (1.0 + 0.1 * randn(4, shape[-1:])).astype(np.float32)
        o = pallas.rmsnorm(xj, pallas.jnp.asarray(g), block_rows=16, interpret=True)
        r = ref.rmsnorm(xt, torch.from_numpy(g))
        assert r.dtype == xt.dtype  # the kernel's dtype, not a promotion
        np.testing.assert_allclose(f32(r), f32(o), rtol=TOLS[dtype], atol=TOLS[dtype])


class TestDispatchOnCpu:
    def test_cpu_tensors_take_plain_path_without_launch(self):
        rng = np.random.default_rng(0)
        before = dict(ops.LAUNCHES)
        x = torch.from_numpy(rng.standard_normal((4, 64)).astype(np.float32))
        g = torch.ones(64)
        assert torch.equal(ops.rmsnorm(x, g), ref.rmsnorm(x, g))
        q = torch.from_numpy(rng.standard_normal((1, 8, 2, 2, 16)).astype(np.float32))
        k = torch.from_numpy(rng.standard_normal((1, 8, 2, 16)).astype(np.float32))
        out = ops.flash_attention(q, k, k, causal=True)
        assert torch.equal(out.view(1, 8, 4, 16), ref.flash_attention(q.view(1, 8, 4, 16), k, k))
        kv_pos = torch.arange(8, dtype=torch.int32)[None]
        pos = torch.tensor([5], dtype=torch.int32)
        d = ops.decode_attention(q[:, 0].reshape(1, 4, 16), k, k, kv_pos, pos)
        assert d.shape == (1, 4, 16)
        o, lse = ref.decode_attention(q[:, 0].reshape(1, 4, 16), k, k, kv_pos, pos,
                                      return_lse=True)
        assert torch.equal(o.to(d.dtype), d) and lse.shape == (1, 4)
        assert ops.LAUNCHES == before


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
class TestKernelsOnCard:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
    @pytest.mark.parametrize("B,H,K,Sq,Sk,dh", [
        (1, 4, 4, 32, 32, 16), (2, 8, 2, 48, 48, 32), (1, 4, 1, 40, 72, 16),
        (1, 8, 8, 130, 130, 32), (1, 4, 4, 15, 15, 128),
        # tensor-core kernel: ragged 64-row tiles, dh 64 and 128, GQA
        (1, 4, 4, 200, 200, 64), (2, 4, 4, 130, 130, 128), (1, 32, 8, 200, 200, 128),
        (1, 8, 2, 77, 140, 64),
        # G = 16 (glm4-9b) and G = 6 (nemotron-4-15b)
        (1, 32, 2, 200, 200, 128), (2, 48, 8, 77, 77, 128),
        # dh = 112 (zamba2-7b): a 64 + 48 column row, ragged tiles; Sq != Sk
        (1, 32, 32, 15, 15, 112), (1, 8, 8, 130, 130, 112), (2, 4, 4, 77, 200, 112),
        # seamless-m4t's cross attention: 15 decoder rows over 512 frames
        (1, 16, 16, 15, 512, 64),
    ])
    def test_flash_attention(self, card, dtype, B, H, K, Sq, Sk, dh):
        from repro_torch.kernels.flash_attention import flash_attention

        t = TORCH[dtype]
        q = torch.from_numpy(randn(0, (B, Sq, H, dh))).to(card, t)
        k = torch.from_numpy(randn(1, (B, Sk, K, dh))).to(card, t)
        v = torch.from_numpy(randn(2, (B, Sk, K, dh))).to(card, t)
        for causal, window in MASKS:
            if causal and Sq > Sk:
                continue
            o = flash_attention(q, k, v, causal=causal, window=window)
            r = ref.flash_attention(q, k, v, causal=causal, window=window)
            torch.testing.assert_close(o.float(), r.float(), rtol=CARD_TOLS[dtype],
                                       atol=CARD_TOLS[dtype])

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_flash_attention_kv_len_and_long_ragged(self, card, dtype):
        """kv_len masks and 16 ragged 64-row tiles (Sq = Sk = 1000)."""
        from repro_torch.kernels.flash_attention import flash_attention

        t = TORCH[dtype]
        q, k, v = (torch.from_numpy(randn(i, (1, 1000, 8, 128))).to(card, t) for i in range(3))
        for causal, window, kv_len in [(True, 0, None), (True, 8, None), (False, 0, 995),
                                       (True, 0, 300)]:
            o = flash_attention(q, k, v, causal=causal, window=window, kv_len=kv_len)
            r = ref.flash_attention(q, k, v, causal=causal, window=window, kv_len=kv_len)
            torch.testing.assert_close(o.float(), r.float(), rtol=TOLS[dtype], atol=TOLS[dtype])

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
    @pytest.mark.parametrize("H,K", [(8, 8), (8, 2)])
    def test_flash_attention_q_offset(self, card, dtype, H, K):
        """One rank's block of query rows at its offset: causal, windowed
        (a window below Sk) and non-causal, offsets that start a tile, fall
        inside one and end the sequence, against the plain version."""
        from repro_torch.kernels.flash_attention import flash_attention

        t, Sk, rows, dh = TORCH[dtype], 512, 96, 128
        q = torch.from_numpy(randn(0, (1, rows, H, dh))).to(card, t)
        k, v = (torch.from_numpy(randn(i, (1, Sk, K, dh))).to(card, t) for i in (1, 2))
        for causal, window in [(True, 0), (True, 100), (False, 0)]:
            for off in (0, 64, 200, Sk - rows):
                o = flash_attention(q, k, v, causal=causal, window=window, q_offset=off)
                r = ref.flash_attention(q, k, v, causal=causal, window=window, q_offset=off)
                torch.testing.assert_close(o.float(), r.float(), rtol=CARD_TOLS[dtype],
                                           atol=CARD_TOLS[dtype])

    def test_flash_attention_rejects_misaligned_bf16(self, card):
        """The tensor-core kernel's TMA maps need 16-byte strides: raise, no detour."""
        from repro_torch.kernels.flash_attention import flash_attention

        kv = torch.zeros((1, 32, 4, 128), device=card, dtype=torch.bfloat16)
        flat = torch.zeros(32 * 4 * 128 + 1, device=card, dtype=torch.bfloat16)
        bad = flat[1:].view(1, 32, 4, 128)  # base pointer 2 bytes off
        with pytest.raises(ValueError, match="16-byte aligned"):
            flash_attention(bad, kv, kv)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("B,H,K,Sc,dh", [(2, 4, 2, 64, 16), (1, 8, 8, 70, 32),
                                             (8, 32, 32, 576, 128), (8, 32, 32, 576, 112),
                                             (2, 4, 4, 130, 112)])
    def test_decode_attention(self, card, dtype, B, H, K, Sc, dh):
        from repro_torch.kernels.decode_attention import decode_attention

        t = TORCH[dtype]
        q, k, v, kv_pos, pos = decode_inputs(B, H, K, Sc, dh)
        kv_pos[0] = -1  # an all-empty row
        args = (torch.from_numpy(q).to(card, t),
                torch.from_numpy(k).transpose(1, 2).to(card, t),
                torch.from_numpy(v).transpose(1, 2).to(card, t),
                torch.from_numpy(kv_pos).to(card), torch.from_numpy(pos).to(card))
        for window in (0, 16):
            o = decode_attention(*args, window=window)
            r = ref.decode_attention(*args, window=window)
            torch.testing.assert_close(o.float(), r.float(), rtol=TOLS[dtype], atol=TOLS[dtype])

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("B,H,K,Sc,dh,case", [
        (2, 8, 2, 1000, 64, "rows"),  # splits > 1 and an all-empty row
        (1, 32, 32, 576, 128, "short"),  # 40 valid slots: most splits empty
        (1, 32, 32, 576, 128, "full"),  # the 512 + 64 calibration
        (1, 32, 32, 576, 128, "ring"),  # a ring window across a split boundary
        (1, 32, 32, 576, 112, "full"),  # zamba2-7b's dh, batch 1
        (2, 8, 2, 1000, 112, "rows"),
    ])
    def test_decode_attention_split(self, card, dtype, B, H, K, Sc, dh, case):
        """Split-K in one launch: right, and bit-identical from call to call."""
        from repro_torch.kernels.decode_attention import decode_attention, decode_splits

        n_sm = torch.cuda.get_device_properties(card).multi_processor_count
        assert decode_splits(B, K, Sc, n_sm) > 1
        t = TORCH[dtype]
        kv_pos, pos, window = split_positions(B, Sc, case)
        args = (torch.from_numpy(randn(0, (B, H, dh))).to(card, t),
                torch.from_numpy(randn(1, (B, Sc, K, dh))).to(card, t),
                torch.from_numpy(randn(2, (B, Sc, K, dh))).to(card, t),
                torch.from_numpy(kv_pos).to(card), torch.from_numpy(pos).to(card))
        o = decode_attention(*args, window=window)
        assert torch.equal(o, decode_attention(*args, window=window))
        r = ref.decode_attention(*args, window=window)
        torch.testing.assert_close(o.float(), r.float(), rtol=TOLS[dtype], atol=TOLS[dtype])
        for b in range(B):
            if (kv_pos[b] < 0).all():
                assert float(o[b].abs().max()) == 0.0

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("B,H,K,Sc,dh", [
        (8, 32, 32, 576, 128),  # one split a (row, head group)
        (1, 32, 32, 576, 128),  # split, merged in the launch
        (8, 32, 2, 2048, 128),  # glm4-9b decode_32k's shard on 16 x 16, split
        (2, 4, 4, 130, 112),
    ])
    def test_decode_attention_lse_mode(self, card, dtype, B, H, K, Sc, dh):
        """The lse mode against the plain version (the f32 output; lse, -inf
        on a row with no valid slot), bit-identical from call to call; its
        two halves' parts merged equal the kernel over the whole cache, and a
        row valid in one half only merges right."""
        from repro_torch.kernels.decode_attention import decode_attention

        t = TORCH[dtype]
        half = Sc // 2
        kv_pos = np.tile(np.arange(Sc, dtype=np.int32), (B, 1))
        pos = np.full((B,), Sc - 1, np.int32)
        kv_pos[0, :half], kv_pos[0, half:], pos[0] = -1, np.arange(Sc - half), Sc - half - 1
        if B > 1:
            kv_pos[1] = -1  # no valid slot
        args = (torch.from_numpy(randn(0, (B, H, dh))).to(card, t),
                torch.from_numpy(randn(1, (B, Sc, K, dh))).to(card, t),
                torch.from_numpy(randn(2, (B, Sc, K, dh))).to(card, t),
                torch.from_numpy(kv_pos).to(card), torch.from_numpy(pos).to(card))
        o, lse = decode_attention(*args, return_lse=True)
        again = decode_attention(*args, return_lse=True)
        assert torch.equal(o, again[0]) and torch.equal(lse, again[1])
        r, r_lse = ref.decode_attention(*args, return_lse=True)
        assert o.dtype == lse.dtype == torch.float32
        torch.testing.assert_close(o, r, rtol=TOLS[dtype], atol=TOLS[dtype])
        assert torch.equal(torch.isneginf(lse), torch.isneginf(r_lse))
        live = ~torch.isneginf(r_lse)
        torch.testing.assert_close(lse[live], r_lse[live], rtol=TOLS[dtype], atol=TOLS[dtype])
        q, k, v, kp, p = args
        parts = [decode_attention(q, k[:, sl], v[:, sl], kp[:, sl], p, return_lse=True)
                 for sl in (slice(0, half), slice(half, Sc))]
        merged = ref.merge_decode_parts([a for a, _ in parts], [b for _, b in parts])
        torch.testing.assert_close(merged.to(t).float(), decode_attention(*args).float(),
                                   rtol=TOLS[dtype], atol=TOLS[dtype])
        assert not torch.isnan(merged).any()
        if B > 1:
            assert float(merged[1].abs().max()) == 0.0

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("B,H,K,Sc,dh", [
        (2, 48, 8, 200, 128),  # G = 6 (nemotron-4-15b)
        (1, 96, 8, 576, 128),  # G = 12 (mistral-large-123b), split
        (8, 32, 2, 576, 128),  # G = 16 (glm4-9b), the ICC batch, split
        (1, 32, 2, 576, 128),  # G = 16, batch 1
        (2, 16, 1, 130, 16),  # G = 16 at dh 16
        (1, 48, 2, 300, 64),  # G = 24: six CTAs of 4 heads per KV head
        (2, 40, 8, 200, 64),  # G = 5: five CTAs of one head
    ])
    def test_decode_attention_any_group(self, card, dtype, B, H, K, Sc, dh):
        """Any G = H / K, in head groups of 4, 2 or 1 heads a CTA; an all-empty
        row, a window, and bit-identical repeats when split."""
        from repro_torch.kernels.decode_attention import decode_attention

        t = TORCH[dtype]
        lengths = [Sc - 3 * b for b in range(B)]
        lengths[-1] = 0 if B > 1 else lengths[-1]
        kv_pos = np.full((B, Sc), -1, np.int32)
        for b, n in enumerate(lengths):
            kv_pos[b, :n] = np.arange(n)
        pos = np.asarray([max(n - 1, 0) for n in lengths], np.int32)
        args = (torch.from_numpy(randn(0, (B, H, dh))).to(card, t),
                torch.from_numpy(randn(1, (B, Sc, K, dh))).to(card, t),
                torch.from_numpy(randn(2, (B, Sc, K, dh))).to(card, t),
                torch.from_numpy(kv_pos).to(card), torch.from_numpy(pos).to(card))
        for window in (0, 16):
            o = decode_attention(*args, window=window)
            assert torch.equal(o, decode_attention(*args, window=window))
            r = ref.decode_attention(*args, window=window)
            torch.testing.assert_close(o.float(), r.float(), rtol=TOLS[dtype], atol=TOLS[dtype])
            if B > 1:
                assert float(o[-1].abs().max()) == 0.0

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
    @pytest.mark.parametrize("shape", [
        (8, 128), (3, 37, 64), (1, 256), (512, 4096),
        # rows around 132 SMs and around rmsnorm_plan's regime threshold, wider rows
        (1, 4096), (8, 4096), (131, 4096), (132, 4096), (133, 4096), (528, 4096),
        (529, 4096), (8192, 4096),
        (8, 5120), (600, 5120), (8, 8192), (600, 8192),
    ])
    def test_rmsnorm(self, card, dtype, shape):
        from repro_torch.kernels.rmsnorm import rmsnorm

        x = torch.from_numpy(randn(3, shape)).to(card, TORCH[dtype])
        g = torch.from_numpy(1.0 + 0.1 * randn(4, shape[-1:])).to(card)
        for gamma in (g, g.to(TORCH[dtype]), torch.ones_like(g, dtype=TORCH[dtype])):
            torch.testing.assert_close(rmsnorm(x, gamma).float(), ref.rmsnorm(x, gamma).float(),
                                       rtol=CARD_TOLS[dtype], atol=CARD_TOLS[dtype])

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
    @pytest.mark.parametrize("case", ["gamma_misaligned", "rows_apart", "d37", "last_token"])
    def test_rmsnorm_scalar_path_and_strided_rows(self, card, dtype, case):
        """The scalar instantiation (misaligned gamma, rows d + 1 apart,
        d = 37) and the final norm's x[:, -1] rows on the vector path."""
        from repro_torch.kernels.rmsnorm import rmsnorm, vector_path

        t, d = TORCH[dtype], 4096
        shape, view = {"gamma_misaligned": ((8, d), lambda a: a),
                       "rows_apart": ((8, d + 1), lambda a: a[:, :d]),
                       "d37": ((15, 37), lambda a: a),
                       "last_token": ((4, 15, d), lambda a: a[:, -1])}[case]
        x = view(torch.from_numpy(randn(3, shape)).to(card, t))  # slice on the card
        n_g = x.shape[-1]
        off = 1 if case == "gamma_misaligned" else 0
        for gdt in (torch.float32, t):
            g = torch.empty(n_g + off, device=card, dtype=gdt)[off:]
            g.copy_(torch.from_numpy(1.0 + 0.1 * randn(4, (n_g,))))
            out = rmsnorm(x, g)
            assert vector_path(x.view(-1, n_g), g, out) == (case == "last_token")
            torch.testing.assert_close(out.float(), ref.rmsnorm(x, g).float(),
                                       rtol=CARD_TOLS[dtype], atol=CARD_TOLS[dtype])


# rmsnorm's backward: the CPU tests' shapes, the training step's (2048, 4096)
# and 64-row f32 rows, rows around its grid (one and two CTAs per SM: 132 and
# 264 on 132 SMs) and the forward plan's regime threshold (528), d = 37 (the
# scalar path), d = 6144, the trained widths (5120, 8192, 12288), 8192 rows
# and d = 16384 (one ring stage in f32)
RMSNORM_BWD_SHAPES = [(8, 128), (3, 37, 64), (1, 256), (15, 4096), (64, 4096), (2048, 4096),
                      (131, 4096), (132, 4096), (133, 4096), (263, 4096), (264, 4096),
                      (265, 4096), (528, 4096), (529, 4096), (15, 37), (8, 6144), (600, 6144),
                      (2048, 5120), (2048, 6144), (2048, 8192), (2048, 12288), (8192, 4096),
                      (8, 16384), (64, 16384)]


@pytest.mark.cuda
class TestRMSNormBackwardOnCard:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
    @pytest.mark.parametrize("shape", RMSNORM_BWD_SHAPES)
    def test_against_plain_and_bit_equal(self, card, dtype, shape):
        from repro_torch.kernels.rmsnorm import rmsnorm_bwd

        t = TORCH[dtype]
        x = torch.from_numpy(randn(3, shape)).to(card, t)
        dy = torch.from_numpy(randn(5, shape)).to(card, t)
        g = torch.from_numpy(1.0 + 0.1 * randn(4, shape[-1:])).to(card)
        for gamma in (g, g.to(t)):
            dx, dg = rmsnorm_bwd(x, gamma, dy)
            rx, rg = ref.rmsnorm_bwd(x, gamma, dy)
            assert dx.dtype == x.dtype and dg.dtype == gamma.dtype
            torch.testing.assert_close(dx.float(), rx.float(), rtol=CARD_TOLS[dtype],
                                       atol=CARD_TOLS[dtype])
            torch.testing.assert_close(dg.float(), rg.float(), rtol=CARD_TOLS[dtype],
                                       atol=CARD_TOLS[dtype])
            dx2, dg2 = rmsnorm_bwd(x, gamma, dy)  # no atomics: the same bits
            assert torch.equal(dx, dx2) and torch.equal(dg, dg2)

    @pytest.mark.parametrize("case", ["shared_memory", "grid"])
    def test_refused_plan_raises_without_fallback(self, card, case):
        """A plan whose ring needs more shared memory than a block has, or
        whose grid cannot be co-resident, is refused at launch: it raises,
        counts no launch and writes nothing."""
        from repro_torch.kernels import _build
        from repro_torch.kernels.rmsnorm import launch_bwd, rmsnorm_bwd_plan

        n_sm = _build.sm_count(card.index or 0)
        n, d = 64 * n_sm if case == "grid" else 64, 16384  # grid: a CTA a row, 64 an SM
        x = torch.zeros((n, d), device=card, dtype=torch.bfloat16)  # never read
        dy = torch.zeros_like(x)
        g = torch.ones(d, device=card, dtype=torch.bfloat16)
        threads, vpt, stages, n_cta = rmsnorm_bwd_plan(n, d, 2, n_sm)
        plan = ((threads, vpt, 8, n_cta) if case == "shared_memory"  # 8 stages of 64 KB
                else (threads, vpt, stages, n))
        dx = torch.full_like(x, float("nan"))
        dgamma = torch.full_like(g, float("nan"))
        before = _build.LAUNCHES["rmsnorm_bwd"]
        with pytest.raises(RuntimeError, match="rmsnorm_bwd"):
            launch_bwd(x, g, dy, dx, dgamma, 1e-5, plan, True)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["rmsnorm_bwd"] == before
        assert dx.isnan().all() and dgamma.isnan().all()

    @pytest.mark.parametrize("case", ["gamma_misaligned", "rows_apart", "last_token", "expanded_dy"])
    def test_scalar_path_strided_rows_and_autograd(self, card, case):
        """Both paths and strided x rows, through `ops.RMSNormFn` too."""
        from repro_torch.kernels import ops
        from repro_torch.kernels.rmsnorm import rmsnorm_bwd

        d = 4096
        shape, view = {"gamma_misaligned": ((8, d), lambda a: a),
                       "rows_apart": ((8, d + 1), lambda a: a[:, :d]),
                       "last_token": ((4, 15, d), lambda a: a[:, -1]),
                       "expanded_dy": ((8, d), lambda a: a)}[case]
        x = view(torch.from_numpy(randn(3, shape)).to(card))
        off = 1 if case == "gamma_misaligned" else 0
        g = torch.empty(d + off, device=card)[off:]
        g.copy_(torch.from_numpy(1.0 + 0.1 * randn(4, (d,))))
        dy = (torch.ones((), device=card).expand(x.shape) if case == "expanded_dy"
              else torch.from_numpy(randn(5, tuple(x.shape))).to(card))
        for a, b in zip(rmsnorm_bwd(x, g, dy), ref.rmsnorm_bwd(x, g, dy)):
            torch.testing.assert_close(a, b, rtol=TOLS["float32"], atol=TOLS["float32"])
        xr, gr = x.clone().requires_grad_(), g.clone().requires_grad_()
        ops.rmsnorm(xr, gr).backward(dy)
        for a, b in zip((xr.grad, gr.grad), ref.rmsnorm_bwd(x, g, dy)):
            torch.testing.assert_close(a, b, rtol=TOLS["float32"], atol=TOLS["float32"])
