"""The port's llama2-7b model against the JAX reference on the CPU.

Weights come from the reference's `Model.init` and are converted; inputs are
made by numpy from a seed and fed to both. Everything runs at the llama2-7b
smoke size in float32 and is held to the reference's model-level tolerance
(`TOL`, as in tests/test_consistency.py).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import RuntimeFlags as JaxFlags  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import attention as jax_attention  # noqa: E402
from repro.models import common as jax_common  # noqa: E402
from repro.models import mlp as jax_mlp  # noqa: E402
from repro.models import rope as jax_rope  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import convert_cache, convert_params, to_tensor  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import attention, common, mlp, rope  # noqa: E402

TOL = 2e-3
S, EXTRA, B = 12, 3, 2
ARCH = "llama2-7b"

_PAIR = {}


def pair():
    """(jax model, jax params, port model, port params) on the same weights."""
    if not _PAIR:
        cfg_j = dataclasses.replace(jax_get_config(ARCH, smoke=True), dtype="float32")
        mj = jax_build_model(cfg_j, JaxFlags(remat=False))
        pj, _ = mj.init(jax.random.PRNGKey(0))
        cfg_t = dataclasses.replace(get_config(ARCH, smoke=True), dtype="float32")
        mt = build_model(cfg_t)
        pt = convert_params(jax.tree.map(np.asarray, pj), cfg_t, device="cpu")
        _PAIR.update(mj=mj, pj=pj, mt=mt, pt=pt)
    return _PAIR["mj"], _PAIR["pj"], _PAIR["mt"], _PAIR["pt"]


def tokens(seq, seed=0):
    cfg = get_config(ARCH, smoke=True)
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, seq), np.int32)


def close(a, b, tol=TOL, msg=""):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=tol, atol=tol, err_msg=msg)


def pad_jax_cache(cache, n):
    cache = dict(cache)
    for k in ("k", "v"):
        cache[k] = jnp.pad(cache[k], ((0, 0), (0, 0), (0, n), (0, 0), (0, 0)))
    cache["pos"] = jnp.pad(cache["pos"], ((0, 0), (0, n)), constant_values=-1)
    return cache


def pad_cache(cache, n):
    out = {}
    for k in ("k", "v"):
        out[k] = torch.nn.functional.pad(cache[k], (0, 0, 0, 0, 0, n))
    out["pos"] = torch.nn.functional.pad(cache["pos"], (0, n), value=-1)
    return out


class TestAgainstJax:
    def test_forward(self):
        mj, pj, mt, pt = pair()
        x = tokens(S)
        lj, _ = mj.forward(pj, jnp.asarray(x))
        lt, _ = mt.forward(pt, torch.from_numpy(x))
        assert lt.shape == lj.shape
        close(lt, lj)

    def test_prefill(self):
        mj, pj, mt, pt = pair()
        x = tokens(S)
        lj, cj = mj.prefill(pj, jnp.asarray(x))
        lt, ct = mt.prefill(pt, torch.from_numpy(x))
        close(lt, lj)
        close(ct["k"], cj["k"])
        close(ct["v"], cj["v"])
        np.testing.assert_array_equal(ct["pos"].numpy(), np.asarray(cj["pos"]))

    def test_decode_steps(self):
        mj, pj, mt, pt = pair()
        x = tokens(S + EXTRA)
        _, cj = mj.prefill(pj, jnp.asarray(x[:, :S]))
        _, ct = mt.prefill(pt, torch.from_numpy(x[:, :S]))
        cj, ct = pad_jax_cache(cj, EXTRA), pad_cache(ct, EXTRA)
        for i in range(EXTRA):
            pos = np.full((B,), S + i, np.int32)
            lj, cj = mj.decode(pj, cj, jnp.asarray(x[:, S + i]), jnp.asarray(pos))
            lt, ct = mt.decode(pt, ct, torch.from_numpy(x[:, S + i]), torch.from_numpy(pos))
            close(lt, lj, msg=f"decode step {i}")
        close(ct["k"], cj["k"])
        np.testing.assert_array_equal(ct["pos"].numpy(), np.asarray(cj["pos"]))

    def test_converted_cache_decodes_same(self):
        mj, pj, mt, pt = pair()
        x = tokens(S + 1, seed=3)
        _, cj = mj.prefill(pj, jnp.asarray(x[:, :S]))
        cj = pad_jax_cache(cj, 4)
        ct = convert_cache(jax.tree.map(np.asarray, cj), device="cpu")
        pos = np.full((B,), S, np.int32)
        lj, _ = mj.decode(pj, cj, jnp.asarray(x[:, S]), jnp.asarray(pos))
        lt, _ = mt.decode(pt, ct, torch.from_numpy(x[:, S]), torch.from_numpy(pos))
        close(lt, lj)


class TestSelfConsistency:
    """The port's analogues of tests/test_consistency.py."""

    def test_prefill_matches_forward(self):
        _, _, mt, pt = pair()
        x = torch.from_numpy(tokens(S, seed=1))
        full, _ = mt.forward(pt, x)
        lg, _ = mt.prefill(pt, x)
        close(lg, full[:, -1].numpy())

    def test_decode_matches_forward(self):
        _, _, mt, pt = pair()
        x = torch.from_numpy(tokens(S + EXTRA, seed=2))
        full, _ = mt.forward(pt, x)
        _, cache = mt.prefill(pt, x[:, :S])
        cache = pad_cache(cache, EXTRA)
        for i in range(EXTRA):
            pos = torch.full((B,), S + i, dtype=torch.int32)
            lg, cache = mt.decode(pt, cache, x[:, S + i], pos)
            close(lg, full[:, S + i].numpy(), msg=f"decode step {i}")


class TestModules:
    def test_rms_norm(self):
        rng = np.random.default_rng(5)
        x = rng.standard_normal((3, 7, 64)).astype(np.float32)
        g = (1.0 + 0.1 * rng.standard_normal(64)).astype(np.float32)
        ref = jax_common.rms_norm(jnp.asarray(x), jnp.asarray(g), 1e-5)
        out = common.rms_norm(torch.from_numpy(x), torch.from_numpy(g), 1e-5)
        close(out, ref, tol=1e-6)

    def test_apply_rope(self):
        rng = np.random.default_rng(6)
        x = rng.standard_normal((2, 9, 4, 32)).astype(np.float32)
        positions = rng.integers(0, 600, (2, 9)).astype(np.int32)
        ref = jax_rope.apply_rope(jnp.asarray(x), jnp.asarray(positions), 32, 1e4)
        out = rope.apply_rope(torch.from_numpy(x), torch.from_numpy(positions), 32, 1e4)
        close(out, ref, tol=2e-5)

    def test_mlp(self):
        _, pj, _, pt = pair()
        cfg = get_config(ARCH, smoke=True)
        x = np.random.default_rng(7).standard_normal((2, 5, cfg.d_model)).astype(np.float32)
        lj = jax.tree.map(lambda a: a[0], pj["layers"]["mlp"])
        ref = jax_mlp.mlp_forward(lj, jnp.asarray(x), cfg)
        out = mlp.mlp_forward(pt.layers[0].mlp, torch.from_numpy(x), cfg)
        close(out, ref, tol=1e-5)

    @pytest.mark.parametrize("causal,window", [(True, 0), (True, 4), (False, 0)])
    def test_naive_attention_with_padding(self, causal, window):
        """Padded KV slots (k_pos = -1) and a fully masked row emit 0."""
        rng = np.random.default_rng(8)
        q = rng.standard_normal((2, 6, 2, 2, 16)).astype(np.float32)
        k = rng.standard_normal((2, 8, 2, 16)).astype(np.float32)
        v = rng.standard_normal((2, 8, 2, 16)).astype(np.float32)
        q_pos = np.tile(np.arange(6, dtype=np.int32), (2, 1))
        k_pos = np.tile(np.arange(8, dtype=np.int32), (2, 1))
        k_pos[1, :] = -1  # batch row 1: every slot padding
        k_pos[0, 5:] = -1
        args_j = [jnp.asarray(a) for a in (q, k, v, q_pos, k_pos)]
        args_t = [torch.from_numpy(a) for a in (q, k, v, q_pos, k_pos)]
        ref = jax_attention.naive_attention(*args_j, causal, window)
        out = attention.naive_attention(*args_t, causal, window)
        close(out, ref, tol=2e-5)
        assert float(out[1].abs().max()) == 0.0


class TestParams:
    def test_init_shapes_and_scales(self):
        """Port init: the reference's shapes (the converted state dict loads
        strictly) and scales (embed 0.02, wo 1/sqrt(H*dh), fan-in, ones)."""
        _, _, mt, pt = pair()
        cfg = mt.cfg
        p = mt.init(seed=1, device="cpu")
        assert {k: v.shape for k, v in p.state_dict().items()} == {
            k: v.shape for k, v in pt.state_dict().items()
        }
        blk = p.layers[0]
        H, dh, d = cfg.n_heads, cfg.head_dim, cfg.d_model
        for t, scale in [
            (p.embed, 0.02), (p.lm_head, d ** -0.5), (blk.attn.wq, d ** -0.5),
            (blk.attn.wo, (H * dh) ** -0.5), (blk.mlp.w2, cfg.d_ff ** -0.5),
        ]:
            assert abs(float(t.std()) / scale - 1.0) < 0.05
        assert float(blk.attn_norm.min()) == float(p.final_norm.max()) == 1.0
        assert not any(t.requires_grad for t in p.parameters())

    def test_bf16_crosses_bit_exact(self):
        a = jax.random.normal(jax.random.PRNGKey(0), (4, 8)).astype(jnp.bfloat16)
        t = to_tensor(np.asarray(a), "cpu")
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            t.view(torch.int16).numpy(), np.asarray(a).view(np.int16)
        )

    def test_seed_reproducible(self):
        _, _, mt, _ = pair()
        a = mt.init(seed=3, device="cpu")
        b = mt.init(seed=3, device="cpu")
        assert torch.equal(a.layers[1].attn.wk, b.layers[1].attn.wk)
