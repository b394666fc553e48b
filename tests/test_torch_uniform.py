"""The port's dense and vlm stack against the JAX reference on the CPU
(the moe family: tests/test_torch_moe.py; hybrid and ssm:
tests/test_torch_ssm.py; enc-dec: tests/test_torch_encdec.py).

Every dense and vlm arch of the JAX package at its smoke size, plus three
cases made with `dataclasses.replace` on a smoke config: tied embeddings,
iRoPE (`nope_interval=2`) and a 16-way GQA group at a small width. The
reference initialises QKV biases to zeros and norms to ones, which would hide
both paths, so every case overwrites them with seeded non-zero values in the
JAX params before conversion. Inputs are made by numpy from a seed; qwen2-vl
takes frontend embeddings (B, S, d) as its prompt and decodes tokens.
Everything runs in float32 at the reference's model-level tolerance (`TOL`,
as in tests/test_consistency.py) and its ring-cache tolerance (5e-3).
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import RuntimeFlags as JaxFlags  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.serving import GenRequest as JaxRequest  # noqa: E402
from repro.serving import InferenceEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get_config, list_configs  # noqa: E402
from repro_torch.convert import convert_params  # noqa: E402
from repro_torch.models import RuntimeFlags, build_model  # noqa: E402
from repro_torch.serving import GenRequest, InferenceEngine  # noqa: E402

TOL = 2e-3
RING_TOL = 5e-3
S, EXTRA, B = 12, 3, 2
DENSE_VLM = ["glm4-9b", "llama2-7b", "mistral-large-123b", "nemotron-4-15b", "qwen1.5-110b",
             "qwen2-vl-72b"]
MOE = ["mixtral-8x22b", "llama4-scout-17b-a16e"]  # held against JAX in test_torch_moe.py
# hybrid, ssm and enc-dec: held against JAX in test_torch_ssm.py and test_torch_encdec.py
OTHER = ["zamba2-7b", "xlstm-1.3b", "seamless-m4t-large-v2"]
CASES = {  # case: (arch, fields replaced on its smoke config)
    "glm4-9b": ("glm4-9b", {}),  # QKV bias, G = 4
    "nemotron-4-15b": ("nemotron-4-15b", {}),  # relu2, no w3
    "qwen1.5-110b": ("qwen1.5-110b", {}),
    "mistral-large-123b": ("mistral-large-123b", {}),
    "qwen2-vl-72b": ("qwen2-vl-72b", {}),  # embeds, M-RoPE, QKV bias
    "tied": ("glm4-9b", {"tie_embeddings": True}),
    "irope": ("mistral-large-123b", {"nope_interval": 2}),  # layer 1 is NoPE
    "g16": ("glm4-9b", {"n_heads": 16, "n_kv_heads": 1}),  # dh 16, G = 16
}
_PAIRS = {}


def _perturbed(params: dict, seed: int) -> dict:
    """numpy params with seeded non-zero QKV biases and norm gammas."""
    rng = np.random.default_rng(seed)
    out = jax.tree.map(lambda a: np.array(a, np.float32), params)
    attn = out["layers"]["attn"]
    for b in ("bq", "bk", "bv"):
        if b in attn:
            attn[b] = (0.1 * rng.standard_normal(attn[b].shape)).astype(np.float32)
    for tree, name in ((out["layers"], "attn_norm"), (out["layers"], "mlp_norm"),
                       (out, "final_norm")):
        tree[name] = (1.0 + 0.1 * rng.standard_normal(tree[name].shape)).astype(np.float32)
    return out


def pair(case):
    """(jax model, jax params, port model, port params) on the same weights."""
    if case not in _PAIRS:
        arch, kw = CASES[case]
        cfg_j = dataclasses.replace(jax_get_config(arch, smoke=True), dtype="float32", **kw)
        mj = jax_build_model(cfg_j, JaxFlags(remat=False))
        pj, _ = mj.init(jax.random.PRNGKey(0))
        pn = _perturbed(pj, seed=list(CASES).index(case))
        cfg_t = dataclasses.replace(get_config(arch, smoke=True), dtype="float32", **kw)
        mt = build_model(cfg_t)
        _PAIRS[case] = (mj, jax.tree.map(jnp.asarray, pn), mt,
                        convert_params(pn, cfg_t, device="cpu"))
    return _PAIRS[case]


def inputs(cfg, seq, seed=0, batch=B):
    """Tokens (batch, seq), or frontend embeds (batch, seq, d) for vlm."""
    rng = np.random.default_rng(seed)
    if cfg.embeds_input:
        return (0.02 * rng.standard_normal((batch, seq, cfg.d_model))).astype(np.float32)
    return rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)


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
    out = {k: torch.nn.functional.pad(cache[k], (0, 0, 0, 0, 0, n)) for k in ("k", "v")}
    out["pos"] = torch.nn.functional.pad(cache["pos"], (0, n), value=-1)
    return out


def prompts(cfg, lengths, seed=0):
    """One prompt per length: (n,) tokens, or (n, d) embeds for vlm."""
    return [inputs(cfg, n, seed + i, batch=1)[0] for i, n in enumerate(lengths)]


@pytest.mark.parametrize("case", list(CASES))
class TestAgainstJax:
    def test_forward(self, case):
        mj, pj, mt, pt = pair(case)
        x = inputs(mt.cfg, S)
        lj, _ = mj.forward(pj, jnp.asarray(x))
        lt, _ = mt.forward(pt, torch.from_numpy(x))
        assert lt.shape == lj.shape
        close(lt, lj)

    def test_prefill(self, case):
        mj, pj, mt, pt = pair(case)
        x = inputs(mt.cfg, S, seed=1)
        lj, cj = mj.prefill(pj, jnp.asarray(x))
        lt, ct = mt.prefill(pt, torch.from_numpy(x))
        close(lt, lj)
        close(ct["k"], cj["k"])
        close(ct["v"], cj["v"])
        np.testing.assert_array_equal(ct["pos"].numpy(), np.asarray(cj["pos"]))

    def test_decode_steps(self, case):
        """Decode after prefill equals JAX's decode and the port's own forward
        (the test_consistency analogue); vlm decodes frontend embeds here."""
        mj, pj, mt, pt = pair(case)
        x = inputs(mt.cfg, S + EXTRA, seed=2)
        full, _ = mt.forward(pt, torch.from_numpy(x))
        _, cj = mj.prefill(pj, jnp.asarray(x[:, :S]))
        _, ct = mt.prefill(pt, torch.from_numpy(x[:, :S]))
        cj, ct = pad_jax_cache(cj, EXTRA), pad_cache(ct, EXTRA)
        for i in range(EXTRA):
            pos = np.full((B,), S + i, np.int32)
            lj, cj = mj.decode(pj, cj, jnp.asarray(x[:, S + i]), jnp.asarray(pos))
            lt, ct = mt.decode(pt, ct, torch.from_numpy(x[:, S + i]), torch.from_numpy(pos))
            close(lt, lj, msg=f"decode step {i} vs JAX")
            close(lt, full[:, S + i], msg=f"decode step {i} vs forward")
        close(ct["k"], cj["k"])

    def test_engine_greedy_equals_jax(self, case):
        mj, pj, mt, pt = pair(case)
        ps = prompts(mt.cfg, [6, 8, 6], seed=10)
        reqs = [GenRequest(uid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(ps)]
        ours = InferenceEngine(mt, pt, max_batch=2, max_seq=24, device="cpu").generate(reqs)
        theirs = JaxEngine(mj, pj, max_batch=2, max_seq=24).generate(
            [JaxRequest(uid=r.uid, prompt=jnp.asarray(r.prompt), max_new_tokens=4)
             for r in reqs])
        for r in reqs:
            assert ours[r.uid].tokens == theirs[r.uid].tokens, r.uid

    def test_batched_equals_sequential(self, case):
        _, _, mt, pt = pair(case)
        ps = prompts(mt.cfg, [5, 9, 7], seed=20)
        reqs = [GenRequest(uid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(ps)]
        batched = InferenceEngine(mt, pt, max_batch=3, max_seq=24, device="cpu").generate(reqs)
        for r in reqs:
            solo = InferenceEngine(mt, pt, max_batch=1, max_seq=24, device="cpu").generate([r])
            assert solo[r.uid].tokens == batched[r.uid].tokens, r.uid


class TestRingCache:
    """Sliding-window serving forced by `window_override` (the analogue of
    tests/test_consistency.py::test_sliding_window_ring_cache)."""

    W = 8

    def _models(self):
        mj, pj, mt, pt = pair("glm4-9b")
        mj = jax_build_model(mj.cfg, JaxFlags(remat=False, window_override=self.W))
        mt = build_model(mt.cfg, RuntimeFlags(window_override=self.W))
        return mj, pj, mt, pt

    def test_ring_decode_matches_windowed_forward_and_jax(self):
        mj, pj, mt, pt = self._models()
        toks = inputs(mt.cfg, 20, seed=9)
        full, _ = mt.forward(pt, torch.from_numpy(toks))  # window applied in-stack
        cj, _ = mj.init_cache(B, self.W)
        ct = mt.init_cache(B, self.W, device="cpu")
        for t in range(20):
            pos = np.full((B,), t, np.int32)
            lj, cj = mj.decode(pj, cj, jnp.asarray(toks[:, t]), jnp.asarray(pos))
            lt, ct = mt.decode(pt, ct, torch.from_numpy(toks[:, t]), torch.from_numpy(pos))
            close(lt, lj, tol=RING_TOL, msg=f"t={t} vs JAX")
            if t >= 1:
                close(lt, full[:, t], tol=RING_TOL, msg=f"t={t} vs windowed forward")
        np.testing.assert_array_equal(ct["pos"].numpy(), np.asarray(cj["pos"]))

    def test_ring_smaller_than_window_raises(self):
        """A cache of W - 1 slots takes positions 0..W - 2; position W - 1
        would overwrite slot 0, which is still inside the window."""
        _, _, mt, pt = self._models()
        cache = mt.init_cache(B, self.W - 1, device="cpu")
        tok = torch.zeros((B,), dtype=torch.int32)
        for t in range(self.W - 1):
            _, cache = mt.decode(pt, cache, tok, torch.full((B,), t, dtype=torch.int32))
        with pytest.raises(ValueError, match="smaller than the window"):
            mt.decode(pt, cache, tok, torch.full((B,), self.W - 1, dtype=torch.int32))

    def test_ring_smaller_than_window_decodes_until_it_would_wrap(self):
        """While no position wraps, the slot each step writes is empty, so
        write-then-attend equals the reference's decode."""
        mj, pj, mt, pt = self._models()
        toks = inputs(mt.cfg, self.W - 1, seed=11)
        cj, _ = mj.init_cache(B, self.W - 1)
        ct = mt.init_cache(B, self.W - 1, device="cpu")
        for t in range(self.W - 1):
            pos = np.full((B,), t, np.int32)
            lj, cj = mj.decode(pj, cj, jnp.asarray(toks[:, t]), jnp.asarray(pos))
            lt, ct = mt.decode(pt, ct, torch.from_numpy(toks[:, t]), torch.from_numpy(pos))
            close(lt, lj, tol=RING_TOL, msg=f"t={t} vs JAX")
        np.testing.assert_array_equal(ct["pos"].numpy(), np.asarray(cj["pos"]))


class TestStack:
    def test_chunked_prefill_equals_naive(self):
        """On the CPU "auto" takes chunked attention above `naive_below` keys,
        with padded tails (12 keys in chunks of 5 and 4)."""
        _, _, mt, pt = pair("glm4-9b")
        x = torch.from_numpy(inputs(mt.cfg, S, seed=3))
        chunked = build_model(mt.cfg, RuntimeFlags(naive_below=4, q_chunk=5, kv_chunk=4))
        a, _ = mt.forward(pt, x)
        b, _ = chunked.forward(pt, x)
        close(b, a.numpy(), tol=2e-5)
        la, ca = mt.prefill(pt, x)
        lb, cb = chunked.prefill(pt, x)
        close(lb, la.numpy(), tol=2e-5)

    def test_attention_impl_rule(self):
        rt = RuntimeFlags(naive_below=16)
        assert rt.attn_impl_for(16, on_cuda=False) == "naive"
        assert rt.attn_impl_for(17, on_cuda=False) == "chunked"
        assert rt.attn_impl_for(17, on_cuda=True) == "pallas"
        assert RuntimeFlags(attention_impl="chunked").attn_impl_for(4, True) == "chunked"
        with pytest.raises(ValueError):
            RuntimeFlags(attention_impl="bogus").attn_impl_for(4, False)

    def test_tied_embeddings_have_no_lm_head(self):
        _, _, mt, pt = pair("tied")
        assert pt.lm_head is None and "lm_head" not in pt.state_dict()
        h = torch.randn(2, mt.cfg.d_model)
        from repro_torch.models.transformer import logits_from_hidden

        lg = logits_from_hidden(pt, mt.cfg, h)
        assert lg.shape == (2, mt.cfg.padded_vocab)

    def test_relu2_mlp_has_no_w3(self):
        _, _, _, pt = pair("nemotron-4-15b")
        assert pt.layers[0].mlp.w3 is None
        assert not any(k.endswith("w3") for k in pt.state_dict())

    def test_mrope_positions_pass_through(self):
        """Text streams (t = h = w = pos) given explicitly equal the default."""
        _, _, mt, pt = pair("qwen2-vl-72b")
        x = torch.from_numpy(inputs(mt.cfg, S, seed=4))
        pos = torch.arange(S, dtype=torch.int32).expand(B, S)
        a, _ = mt.forward(pt, x)
        b, _ = mt.forward(pt, x, mrope_positions=pos[None].expand(3, B, S))
        assert torch.equal(a, b)
        other = torch.stack([pos, pos // 2, pos % 3])
        c, _ = mt.forward(pt, x, mrope_positions=other)
        assert not torch.allclose(a, c)
        lc, _ = mt.prefill(pt, x, mrope_positions=other)
        close(lc, c[:, -1].numpy(), tol=1e-5)


@pytest.mark.parametrize("case", ["glm4-9b", "nemotron-4-15b", "qwen2-vl-72b"])
def test_calibration_runs(case):
    """measure_service_time and the service-time callable on any arch (token
    prompts, as the reference times vlm archs too)."""
    from repro_torch.serving import measured_service_fn

    _, _, mt, pt = pair(case)
    fn, t = measured_service_fn(mt, pt, 5, 3, max_seq=16, repeats=1)
    assert t["prefill_s"] > 0 and t["decode_s"] > 0
    assert fn(types.SimpleNamespace(n_input=5, n_output=3)) == pytest.approx(
        t["prefill_s"] + t["decode_s"])


@pytest.mark.parametrize("arch", DENSE_VLM + MOE + OTHER)
def test_configs_equal_reference(arch):
    for smoke in (False, True):
        assert dataclasses.asdict(get_config(arch, smoke=smoke)) == \
            dataclasses.asdict(jax_get_config(arch, smoke=smoke))
    assert arch in list_configs()
