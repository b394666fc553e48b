"""The port's enc-dec family (seamless-m4t-large-v2) against the JAX
reference on the CPU.

Cross attention first: `attention_forward(cross_kv=...)` and the cross
decode over a static cache whose padded frames carry position -1, against
the reference's `attention_forward` and `decode_attention(cross=True)` on
the same weights. Then the model through forward, prefill (self and cross
caches) and decode at `TOL` (f32, as tests/test_consistency.py), with
seeded norms and biases; the engine with `enc_len`: greedy tokens equal to
the JAX engine's, batched equal to solo, an encoder prompt shorter than
`enc_len`; and `convert_params` / `convert_cache` on the enc-dec trees.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import RuntimeFlags as JaxFlags  # noqa: E402
from repro.models import attention as jax_attention  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.serving import GenRequest as JaxRequest  # noqa: E402
from repro.serving import InferenceEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import convert_cache, convert_params  # noqa: E402
from repro_torch.models import RuntimeFlags, build_model  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models.encdec import EncDec  # noqa: E402
from repro_torch.models.rope import rope_tables  # noqa: E402
from repro_torch.serving import GenRequest, InferenceEngine  # noqa: E402

TOL = 2e-3
ARCH = "seamless-m4t-large-v2"
SE, SD, EXTRA, B = 10, 6, 3, 2
_PAIR = {}


def perturbed(tree, seed):
    """numpy f32 copy with seeded norms (ones at init) and QKV biases."""
    rng = np.random.default_rng(seed)

    def walk(t):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                out[k] = walk(v)
                continue
            a = np.array(v, np.float32)
            if k.endswith("norm"):
                a = (1.0 + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
            elif k in ("bq", "bk", "bv"):
                a = (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
            out[k] = a
        return out

    return walk(tree)


def close(a, b, tol=TOL, msg=""):
    a = a.detach().float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=tol, atol=tol, err_msg=msg)


def pair(**kw):
    """(jax model, jax params, port model, port params); `qkv_bias` in kw
    gives the cross projections biases too."""
    key = tuple(sorted(kw.items()))
    if key not in _PAIR:
        cfg_j = dataclasses.replace(jax_get_config(ARCH, smoke=True), dtype="float32", **kw)
        cfg_t = dataclasses.replace(get_config(ARCH, smoke=True), dtype="float32", **kw)
        mj = jax_build_model(cfg_j, JaxFlags(remat=False))
        pj, _ = mj.init(jax.random.PRNGKey(0))
        pn = perturbed(pj, seed=len(_PAIR))
        _PAIR[key] = (mj, jax.tree.map(jnp.asarray, pn), build_model(cfg_t),
                      convert_params(pn, cfg_t, device="cpu"))
    return _PAIR[key]


def batch(cfg, se=SE, sd=SD, seed=0, b=B):
    rng = np.random.default_rng(seed)
    enc = (0.5 * rng.standard_normal((b, se, cfg.d_model))).astype(np.float32)
    dec = rng.integers(0, cfg.vocab_size, (b, sd)).astype(np.int32)
    return enc, dec


def jbatch(enc, dec):
    return {"enc_embeds": jnp.asarray(enc), "dec_tokens": jnp.asarray(dec)}


def tbatch(enc, dec):
    return {"enc_embeds": torch.from_numpy(enc), "dec_tokens": torch.from_numpy(dec)}


class TestCrossAttention:
    @pytest.mark.parametrize("qkv_bias", [False, True])
    @pytest.mark.parametrize("impl", ["naive", "chunked", "pallas"])
    def test_cross_forward_equals_jax(self, qkv_bias, impl):
        """Sq != Sk, full mask, q rotated, k/v not; chunked and the kernel's
        plain version (the card's dispatch) alike."""
        _, pj, mt, pt = pair(qkv_bias=qkv_bias)
        cfg = mt.cfg
        lj, lt = pj["dec_layers"], pt.dec_layers[0].cross_attn
        lj = jax.tree.map(lambda a: a[0], lj["cross_attn"])
        rng = np.random.default_rng(1)
        x = rng.standard_normal((B, 7, cfg.d_model)).astype(np.float32)
        mem = rng.standard_normal((B, 13, cfg.d_model)).astype(np.float32)
        pos = np.broadcast_to(np.arange(7, dtype=np.int32), (B, 7))
        epos = np.broadcast_to(np.arange(13, dtype=np.int32), (B, 13))
        ckv_j = jax_attention.project_kv(lj, jnp.asarray(mem), cfg)
        yj, _ = jax_attention.attention_forward(
            lj, jnp.asarray(x), cfg, JaxFlags(), jnp.asarray(pos),
            cross_kv=ckv_j, cross_pos=jnp.asarray(epos))
        rt = RuntimeFlags(attention_impl=impl, q_chunk=3, kv_chunk=5)
        ckv_t = attention.project_kv(lt, torch.from_numpy(mem))
        close(ckv_t[0], ckv_j[0], 1e-5)
        tpos = torch.from_numpy(pos.copy())
        yt, _ = attention.attention_forward(
            lt, torch.from_numpy(x), cfg, rt, tpos, rope_tables(tpos, cfg.head_dim,
                                                                cfg.rope_theta),
            cross_kv=ckv_t, cross_pos=torch.from_numpy(epos.copy()))
        close(yt, yj, 1e-4)

    def test_cross_decode_equals_jax_with_padded_frames(self):
        """The static cross cache with frames 9.. padded (-1): softmax over
        the valid frames only, at decoder positions below and above S_enc."""
        _, pj, mt, pt = pair()
        cfg = mt.cfg
        lj = jax.tree.map(lambda a: a[1], pj["dec_layers"]["cross_attn"])
        lt = pt.dec_layers[1].cross_attn
        rng = np.random.default_rng(2)
        Se = 12
        x = rng.standard_normal((B, cfg.d_model)).astype(np.float32)
        ck = rng.standard_normal((B, Se, cfg.n_kv_heads, cfg.head_dim)).astype(np.float32)
        cv = rng.standard_normal((B, Se, cfg.n_kv_heads, cfg.head_dim)).astype(np.float32)
        cpos = np.broadcast_to(np.arange(Se, dtype=np.int32), (B, Se)).copy()
        cpos[1, 9:] = -1
        for p in (0, 3, 20):
            pos = np.full((B,), p, np.int32)
            yj, _ = jax_attention.decode_attention(
                lj, jnp.asarray(x), cfg, JaxFlags(), jnp.asarray(pos), jnp.asarray(ck),
                jnp.asarray(cv), jnp.asarray(cpos), cross=True)
            tp = torch.from_numpy(pos)
            ct = torch.from_numpy(ck)
            before = ct.clone()
            yt = attention.cross_decode_attention(
                lt, torch.from_numpy(x), rope_tables(tp[:, None], cfg.head_dim, cfg.rope_theta),
                ct, torch.from_numpy(cv), torch.from_numpy(cpos),
                torch.full((B,), Se, dtype=torch.int32))
            close(yt, yj, 1e-4, msg=f"decoder position {p}")
            assert torch.equal(ct, before)  # the cross cache is never written


class TestAgainstJax:
    def test_forward(self):
        mj, pj, mt, pt = pair()
        enc, dec = batch(mt.cfg)
        lj, _ = mj.forward(pj, jbatch(enc, dec))
        lt, aux = mt.forward(pt, tbatch(enc, dec))
        assert lt.shape == lj.shape and aux == {}
        close(lt, lj)

    def test_prefill(self):
        mj, pj, mt, pt = pair()
        enc, dec = batch(mt.cfg, seed=1)
        lj, cj = mj.prefill(pj, jbatch(enc, dec))
        lt, ct = mt.prefill(pt, tbatch(enc, dec))
        close(lt, lj)
        assert set(ct) == set(cj)
        for k in ("k", "v", "cross_k", "cross_v"):
            close(ct[k], cj[k], msg=k)
        for k in ("pos", "cross_pos"):
            np.testing.assert_array_equal(ct[k].numpy(), np.asarray(cj[k]))

    def test_decode_steps(self):
        """Decode after prefill equals JAX's decode and the port's forward."""
        mj, pj, mt, pt = pair()
        enc, dec = batch(mt.cfg, sd=SD + EXTRA, seed=2)
        full, _ = mt.forward(pt, tbatch(enc, dec))
        _, cj = mj.prefill(pj, jbatch(enc, dec[:, :SD]))
        _, ct = mt.prefill(pt, tbatch(enc, dec[:, :SD]))
        cj = dict(cj)
        for k in ("k", "v"):
            cj[k] = jnp.pad(cj[k], ((0, 0), (0, 0), (0, EXTRA), (0, 0), (0, 0)))
            ct[k] = torch.nn.functional.pad(ct[k], (0, 0, 0, 0, 0, EXTRA))
        cj["pos"] = jnp.pad(cj["pos"], ((0, 0), (0, EXTRA)), constant_values=-1)
        ct["pos"] = torch.nn.functional.pad(ct["pos"], (0, EXTRA), value=-1)
        cross = ct["cross_k"].clone()
        for i in range(EXTRA):
            pos = np.full((B,), SD + i, np.int32)
            lj, cj = mj.decode(pj, cj, jnp.asarray(dec[:, SD + i]), jnp.asarray(pos))
            lt, ct = mt.decode(pt, ct, torch.from_numpy(dec[:, SD + i]), torch.from_numpy(pos))
            close(lt, lj, msg=f"decode step {i} vs JAX")
            close(lt, full[:, SD + i], msg=f"decode step {i} vs forward")
        close(ct["k"], cj["k"])
        np.testing.assert_array_equal(ct["pos"].numpy(), np.asarray(cj["pos"]))
        assert torch.equal(ct["cross_k"], cross)

    def test_converted_cache_decodes_same(self):
        mj, pj, mt, pt = pair()
        enc, dec = batch(mt.cfg, sd=SD + 1, seed=3)
        _, cj = mj.prefill(pj, jbatch(enc, dec[:, :SD]))
        _, ct = mt.prefill(pt, tbatch(enc, dec[:, :SD]))
        conv = convert_cache(jax.tree.map(np.asarray, cj), device="cpu")
        assert conv["cross_pos"].dtype == torch.int32
        pos = torch.full((B,), SD - 1, dtype=torch.int32)  # rewrite the last slot
        tok = torch.from_numpy(dec[:, SD - 1])
        a, _ = mt.decode(pt, ct, tok, pos)
        b, _ = mt.decode(pt, conv, tok, pos)
        close(a, b.numpy())

    def test_init_cache_matches_jax(self):
        mj, _, mt, _ = pair()
        cj, _ = mj.init_cache(3, 16, enc_len=10)
        ct = mt.init_cache(3, 16, device="cpu", enc_len=10)
        assert set(ct) == set(cj)
        for k, v in cj.items():
            np.testing.assert_array_equal(ct[k].numpy(), np.asarray(v), err_msg=k)
        # enc_len 0: the cross cache takes the self cache's length, as the reference
        assert mt.init_cache(1, 16, device="cpu")["cross_k"].shape[2] == 16


def requests(cfg, lengths, seed=10, new=4):
    rng = np.random.default_rng(seed)
    reqs = []
    for i, (se, sd) in enumerate(lengths):
        enc = (0.5 * rng.standard_normal((se, cfg.d_model))).astype(np.float32)
        dec = rng.integers(0, cfg.vocab_size, (sd,)).astype(np.int32)
        reqs.append(GenRequest(uid=i, prompt={"enc_embeds": enc, "dec_tokens": dec},
                               max_new_tokens=new))
    return reqs


class TestEngine:
    LENGTHS = [(10, 4), (7, 5), (10, 3)]  # (encoder frames, decoder prompt); enc_len 10

    def test_greedy_equals_jax_engine(self):
        mj, pj, mt, pt = pair()
        reqs = requests(mt.cfg, self.LENGTHS)
        ours = InferenceEngine(mt, pt, max_batch=2, max_seq=24, enc_len=10,
                               device="cpu").generate(reqs)
        theirs = JaxEngine(mj, pj, max_batch=2, max_seq=24, enc_len=10).generate(
            [JaxRequest(uid=r.uid, prompt={k: jnp.asarray(v) for k, v in r.prompt.items()},
                        max_new_tokens=r.max_new_tokens) for r in reqs])
        for r in reqs:
            assert ours[r.uid].tokens == theirs[r.uid].tokens, r.uid

    def test_batched_equals_sequential(self):
        _, _, mt, pt = pair()
        reqs = requests(mt.cfg, self.LENGTHS, seed=11)
        batched = InferenceEngine(mt, pt, max_batch=3, max_seq=24, enc_len=10,
                                  device="cpu").generate(reqs)
        for r in reqs:
            solo = InferenceEngine(mt, pt, max_batch=1, max_seq=24, enc_len=10,
                                   device="cpu").generate([r])
            assert solo[r.uid].tokens == batched[r.uid].tokens, r.uid

    def test_short_encoder_prompt_pads_cross_positions(self):
        """An encoder prompt shorter than enc_len fills its slot's cross
        positions with -1 past its frames, its cross K/V with 0."""
        _, _, mt, pt = pair()
        eng = InferenceEngine(mt, pt, max_batch=2, max_seq=24, enc_len=10, device="cpu")
        (r,) = requests(mt.cfg, [(6, 3)], seed=12, new=5)
        slot = eng.submit(r)
        cp = eng._cache["cross_pos"][slot]
        assert cp[:6].tolist() == list(range(6)) and (cp[6:] == -1).all()
        assert (eng._cache["cross_k"][:, slot, 6:] == 0).all()
        assert (eng._cache["pos"][slot, 3:] == -1).all()

    def test_encoder_prompt_longer_than_enc_len_raises(self):
        _, _, mt, pt = pair()
        eng = InferenceEngine(mt, pt, max_batch=1, max_seq=24, enc_len=8, device="cpu")
        (r,) = requests(mt.cfg, [(9, 3)])
        with pytest.raises(ValueError, match="enc_len"):
            eng.submit(r)


def test_rmsnorm_inputs_are_rows_of_one_stride(monkeypatch):
    """The rmsnorm kernel takes rows one stride apart (`x.view(-1, d)`):
    every norm of the encoder and decoder hands it such rows (the CPU path
    would take any layout)."""
    from repro_torch.kernels import ops

    plain = ops.rmsnorm

    def card_layout(x, gamma, eps=1e-5):
        x.view(-1, x.shape[-1])  # raises as the card's wrapper does
        return plain(x, gamma, eps)

    monkeypatch.setattr(ops, "rmsnorm", card_layout)
    _, _, mt, pt = pair()
    enc, dec = batch(mt.cfg, seed=5)
    mt.forward(pt, tbatch(enc, dec))
    _, cache = mt.prefill(pt, tbatch(enc, dec))
    for k in ("k", "v"):
        cache[k] = torch.nn.functional.pad(cache[k], (0, 0, 0, 0, 0, 1))
    cache["pos"] = torch.nn.functional.pad(cache["pos"], (0, 1), value=-1)
    mt.decode(pt, cache, torch.from_numpy(dec[:, 0]), torch.full((B,), SD, dtype=torch.int32))


class TestParams:
    def test_tree_and_strict_conversion(self):
        mj, _, mt, pt = pair()
        assert isinstance(pt, EncDec) and mt.is_encdec
        assert len(pt.enc_layers) == mt.cfg.n_encoder_layers
        assert len(pt.dec_layers) == mt.cfg.n_layers
        pj, _ = mj.init(jax.random.PRNGKey(1))
        pn = jax.tree.map(np.asarray, pj)
        names = set(pt.state_dict())
        assert {"enc_final_norm", "dec_layers.0.cross_attn.wq", "enc_layers.1.mlp.w3"} <= names
        missing = dict(pn, dec_layers={k: v for k, v in pn["dec_layers"].items()
                                       if k != "cross_norm"})
        with pytest.raises(RuntimeError, match="Missing key"):
            convert_params(missing, mt.cfg, device="cpu")
        with pytest.raises(RuntimeError, match="Unexpected key"):
            convert_params(dict(pn, bogus=np.zeros(2, np.float32)), mt.cfg, device="cpu")

    def test_random_init_runs(self):
        _, _, mt, _ = pair()
        p = mt.init(seed=0, device="cpu")
        enc, dec = batch(mt.cfg, seed=4)
        lg, _ = mt.forward(p, tbatch(enc, dec))
        assert torch.isfinite(lg).all() and float(p.enc_final_norm.min()) == 1.0
