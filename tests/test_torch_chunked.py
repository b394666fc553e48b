"""The port's plain pieces against the JAX package, where no other test
holds them: `chunked_attention` (against the JAX `chunked_attention` and the
port's naive path), M-RoPE (against the JAX `apply_mrope`; text streams equal
RoPE), and the decode kernel's plain version and head grouping at the group
sizes of glm4-9b (G = 16) and mistral-large-123b (G = 12), against the
Pallas decode kernel in interpret mode. Tolerances are the reference's:
2e-5 for attention in f32 (tests/test_attention.py), `TOLS` for kernels
(tests/test_kernels.py).
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from repro.models.attention import chunked_attention as jax_chunked  # noqa: E402
from repro.models.rope import apply_mrope as jax_apply_mrope  # noqa: E402
from repro.models.rope import apply_rope as jax_apply_rope  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    CTA_HEADS, MAX_SPLITS, decode_splits, head_groups)
from repro_torch.models.attention import chunked_attention, naive_attention  # noqa: E402
from repro_torch.models.rope import (  # noqa: E402
    apply_mrope, apply_rope, text_mrope_positions)

ATTN_TOL = 2e-5
TOLS = {"float32": 2e-5, "bfloat16": 2e-2}


def randn(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@st.composite
def attn_case(draw):
    """tests/test_attention.py's cases, plus padded KV slots (k_pos = -1) in
    a tail, which with a window leave whole query rows fully masked."""
    B = draw(st.integers(1, 2))
    K = draw(st.sampled_from([1, 2]))
    G = draw(st.sampled_from([1, 2, 4, 16]))
    Sq = draw(st.integers(1, 40))
    dh = draw(st.sampled_from([8, 16]))
    causal = draw(st.booleans())
    Sk = Sq if causal else draw(st.integers(1, 48))
    window = draw(st.sampled_from([0, 4, 16]))
    qc = draw(st.sampled_from([4, 8, 16]))
    kc = draw(st.sampled_from([4, 8, 16]))
    n_pad = draw(st.integers(0, Sk))  # trailing KV slots marked empty
    return B, K, G, Sq, Sk, dh, causal, window, qc, kc, n_pad


def attn_inputs(case):
    B, K, G, Sq, Sk, dh, causal, window, qc, kc, n_pad = case
    q, k, v = randn(Sq, (B, Sq, K, G, dh)), randn(Sk, (B, Sk, K, dh)), randn(Sk + 1, (B, Sk, K, dh))
    q_pos = np.broadcast_to(np.arange(Sq, dtype=np.int32), (B, Sq)).copy()
    k_pos = np.broadcast_to(np.arange(Sk, dtype=np.int32), (B, Sk)).copy()
    k_pos[:, Sk - n_pad:] = -1
    return q, k, v, q_pos, k_pos


class TestChunkedAttention:
    @given(case=attn_case())
    @settings(max_examples=25, deadline=None)
    def test_equals_jax_chunked_and_naive(self, case):
        B, K, G, Sq, Sk, dh, causal, window, qc, kc, n_pad = case
        arrs = attn_inputs(case)
        t = [torch.from_numpy(a) for a in arrs]
        out = chunked_attention(*t, causal, window, qc, kc)
        assert out.shape == (B, Sq, K, G, dh) and out.dtype == torch.float32
        ref_j = jax_chunked(*(jnp.asarray(a) for a in arrs), causal, window, qc, kc)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref_j), rtol=ATTN_TOL, atol=ATTN_TOL)
        naive = naive_attention(*t, causal, window)
        np.testing.assert_allclose(out.numpy(), naive.numpy(), rtol=ATTN_TOL, atol=ATTN_TOL)

    def test_fully_masked_rows_emit_zero(self):
        """A batch row with every KV slot empty, and query rows that a window
        cuts off from every valid key, give 0 (the online-softmax l = 0 rule)."""
        case = (2, 2, 4, 20, 20, 16, True, 4, 8, 4, 0)
        q, k, v, q_pos, k_pos = attn_inputs(case)
        k_pos[1] = -1
        k_pos[0, 6:] = -1  # rows 10.. of batch 0 see no key inside their window
        t = [torch.from_numpy(a) for a in (q, k, v, q_pos, k_pos)]
        out = chunked_attention(*t, True, 4, 8, 4)
        assert float(out[1].abs().max()) == 0.0
        assert float(out[0, 10:].abs().max()) == 0.0
        ref_j = jax_chunked(*(jnp.asarray(a) for a in (q, k, v, q_pos, k_pos)), True, 4, 8, 4)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref_j), rtol=ATTN_TOL, atol=ATTN_TOL)

    def test_bf16_rounds_p_before_pv(self):
        """In bf16 the probabilities are cast to v's dtype before P.V, as the
        reference does; the result stays in q's dtype."""
        q, k, v, q_pos, k_pos = attn_inputs((1, 2, 2, 24, 24, 16, True, 0, 8, 8, 0))
        t = [torch.from_numpy(a) for a in (q, k, v)]
        tb = [a.bfloat16() for a in t]
        pos = [torch.from_numpy(a) for a in (q_pos, k_pos)]
        out = chunked_attention(*tb, *pos, True, 0, 8, 8)
        assert out.dtype == torch.bfloat16
        ref_j = jax_chunked(*(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)),
                            jnp.asarray(q_pos), jnp.asarray(k_pos), True, 0, 8, 8)
        np.testing.assert_allclose(out.float().numpy(), np.asarray(ref_j, np.float32),
                                   rtol=TOLS["bfloat16"], atol=TOLS["bfloat16"])


class TestMRope:
    @pytest.mark.parametrize("sections,dh", [((8, 4, 4), 32), ((16, 24, 24), 128)])
    def test_equals_jax(self, sections, dh):
        rng = np.random.default_rng(11)
        x = rng.standard_normal((2, 7, 3, dh)).astype(np.float32)
        pos3 = rng.integers(0, 300, (3, 2, 7)).astype(np.int32)
        ref_j = jax_apply_mrope(jnp.asarray(x), jnp.asarray(pos3), dh, 1e4, sections)
        out = apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3), dh, 1e4, sections)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref_j), rtol=2e-5, atol=2e-5)

    def test_text_positions_equal_rope(self):
        rng = np.random.default_rng(12)
        x = torch.from_numpy(rng.standard_normal((2, 9, 4, 32)).astype(np.float32))
        pos = torch.from_numpy(rng.integers(0, 600, (2, 9)).astype(np.int32))
        m = apply_mrope(x, text_mrope_positions(pos), 32, 1e4, (8, 4, 4))
        assert torch.equal(m, apply_rope(x, pos, 32, 1e4))
        ref_j = jax_apply_rope(jnp.asarray(x.numpy()), jnp.asarray(pos.numpy()), 32, 1e4)
        np.testing.assert_allclose(m.numpy(), np.asarray(ref_j), rtol=2e-5, atol=2e-5)

    def test_sections_must_cover_half_dim(self):
        x = torch.zeros(1, 2, 1, 32)
        with pytest.raises(ValueError, match="sum"):
            apply_mrope(x, torch.zeros(3, 1, 2, dtype=torch.int32), 32, 1e4, (8, 4, 2))


@pytest.fixture(scope="module")
def pallas():
    from repro.kernels.decode_attention import decode_attention

    return types.SimpleNamespace(decode=decode_attention)


class TestDecodeGroups:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("H,K", [(12, 1), (24, 2), (16, 1), (32, 2)])  # G = 12, 16
    def test_plain_equals_pallas(self, pallas, dtype, H, K):
        B, Sc, dh = 2, 64, 16
        q, k, v = randn(0, (B, H, dh)), randn(1, (B, K, Sc, dh)), randn(2, (B, K, Sc, dh))
        kv_pos = np.broadcast_to(np.arange(Sc, dtype=np.int32), (B, Sc)).copy()
        kv_pos[kv_pos >= Sc - 7] = -1
        pos = np.asarray([Sc - 8, 30], np.int32)
        jdt = getattr(jnp, dtype)
        tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
        for window in (0, 16):
            o = pallas.decode(*(jnp.asarray(a).astype(jdt) for a in (q, k, v)),
                              jnp.asarray(kv_pos), jnp.asarray(pos), window=window,
                              block_k=16, interpret=True)
            r = ref.decode_attention(
                torch.from_numpy(q).to(tdt), torch.from_numpy(k).transpose(1, 2).to(tdt),
                torch.from_numpy(v).transpose(1, 2).to(tdt), torch.from_numpy(kv_pos),
                torch.from_numpy(pos), window=window)
            np.testing.assert_allclose(r.float().numpy(), np.asarray(o, np.float32),
                                       rtol=TOLS[dtype], atol=TOLS[dtype])

    @pytest.mark.parametrize("G,want", [(1, 1), (2, 1), (3, 3), (4, 1), (5, 5), (6, 3),
                                        (8, 2), (12, 3), (16, 4), (17, 17), (24, 6)])
    def test_head_groups(self, G, want):
        n = head_groups(G)
        assert n == want and G % n == 0 and G // n in CTA_HEADS

    @pytest.mark.parametrize("B,K,G,Sc,want", [
        (8, 2, 16, 576, 3),  # glm4-9b, the ICC batch: 64 CTAs of 4 heads, 3 splits
        (1, 2, 16, 576, 9),  # glm4-9b, batch 1: 8 CTAs, 9 splits of one tile
        (1, 8, 12, 576, 5),  # mistral-large-123b, batch 1: 24 CTAs
        (8, 8, 6, 576, 1),  # nemotron-4-15b, the ICC batch: 192 CTAs of 2 heads
    ])
    def test_splits_at_new_shapes(self, B, K, G, Sc, want):
        """The wrapper splits over B * K * head_groups(G) CTAs."""
        assert decode_splits(B, K * head_groups(G), Sc, 132) == want <= MAX_SPLITS

    @pytest.mark.parametrize("splits", [1, 3, 9])
    def test_split_rule_at_g16(self, splits):
        """The split-and-merge rule the kernel runs, at glm4-9b's group."""
        B, H, K, Sc, dh = 2, 32, 2, 576, 32
        q, k, v = (torch.from_numpy(randn(i, s)) for i, s in
                   enumerate([(B, H, dh), (B, Sc, K, dh), (B, Sc, K, dh)]))
        kv_pos = torch.full((B, Sc), -1, dtype=torch.int32)
        kv_pos[0, :560] = torch.arange(560, dtype=torch.int32)
        kv_pos[1, :30] = torch.arange(30, dtype=torch.int32)
        pos = torch.tensor([559, 29], dtype=torch.int32)
        want = ref.decode_attention(q, k, v, kv_pos, pos)
        got = ref.decode_attention_split(q, k, v, kv_pos, pos, splits=splits)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5, atol=2e-5)
