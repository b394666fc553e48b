"""The port's hybrid (zamba2) and ssm (xlstm) families against the JAX
reference on the CPU.

Modules first, on the same numpy weights and inputs: `mamba2_forward` and
`mamba2_decode_step` at 1e-4, mLSTM and sLSTM forward and decode at 2e-4
(the reference's own bars in tests/test_components.py). Then the stacks
through forward, prefill and decode at `TOL` (f32, as
tests/test_consistency.py): the smoke configs, a zamba2 with a remainder
group (5 layers, a shared block every 2) and one at zamba2-7b's attention
width dh = 112 (d_model 448, 4 heads). The reference initialises norms to
ones, biases and A_log to zeros, which would hide those paths, so every
case overwrites them with seeded values before conversion. Last the engine:
greedy tokens equal to the JAX engine's, batched equal to solo (as
tests/test_serving.py), and `convert_params` strict on the new trees.
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
from repro.models import mamba2 as jax_mamba2  # noqa: E402
from repro.models import xlstm as jax_xlstm  # noqa: E402
from repro.models.common import Initializer  # noqa: E402
from repro.serving import GenRequest as JaxRequest  # noqa: E402
from repro.serving import InferenceEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import convert_cache, convert_params, to_tensor  # noqa: E402
from repro_torch.models import RuntimeFlags, build_model  # noqa: E402
from repro_torch.models import mamba2, xlstm  # noqa: E402
from repro_torch.models.transformer import group_shape  # noqa: E402
from repro_torch.serving import GenRequest, InferenceEngine  # noqa: E402

TOL = 2e-3
S, EXTRA, B = 12, 3, 2
CASES = {  # case: (arch, fields replaced on its smoke config)
    "zamba2-7b": ("zamba2-7b", {}),  # 2 layers, a shared block every 2: no remainder
    "zamba2-rem": ("zamba2-7b", {"n_layers": 5}),  # 2 groups of 2 and a remainder of 1
    "zamba2-dh112": ("zamba2-7b", {"d_model": 448, "n_heads": 4, "n_kv_heads": 4}),
    "xlstm-1.3b": ("xlstm-1.3b", {}),  # one group: an mLSTM and an sLSTM block
    "xlstm-2groups": ("xlstm-1.3b", {"n_layers": 4}),
}
PERTURB = {  # leaf -> (offset, scale): seeded values where the init is constant
    "norm": (1.0, 0.1), "attn_norm": (1.0, 0.1), "mlp_norm": (1.0, 0.1),
    "final_norm": (1.0, 0.1), "ffn_norm": (1.0, 0.1), "D": (1.0, 0.1), "skip": (1.0, 0.1),
    "dt_bias": (0.0, 0.3), "A_log": (0.0, 0.3), "b_if": (0.0, 0.3), "b_gates": (0.0, 0.3),
}
_PAIRS = {}


def perturbed(tree, seed):
    """numpy copy of a params tree, f32, with PERTURB's leaves seeded."""
    rng = np.random.default_rng(seed)

    def walk(t):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            else:
                a = np.array(v, np.float32)
                if k in PERTURB:
                    off, sc = PERTURB[k]
                    a = (off + sc * rng.standard_normal(a.shape)).astype(np.float32)
                out[k] = a
        return out

    return walk(tree)


def close(a, b, tol=TOL, msg=""):
    a = a.detach().float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=tol, atol=tol, err_msg=msg)


def close_tree(ours, theirs, tol, msg=""):
    for k, v in theirs.items():
        if isinstance(v, dict):
            close_tree(ours[k], v, tol, f"{msg}{k}.")
        else:
            close(ours[k], v, tol, msg=msg + k)


def cfg_pair(arch, **kw):
    cj = dataclasses.replace(jax_get_config(arch, smoke=True), dtype="float32", **kw)
    ct = dataclasses.replace(get_config(arch, smoke=True), dtype="float32", **kw)
    return cj, ct


def module_pair(jax_init, torch_cls, cfg_j, cfg_t, seed=0):
    """(jax params, port module) of one block on the same perturbed weights."""
    pn = perturbed(jax_init(Initializer(jax.random.PRNGKey(seed), jnp.float32), cfg_j), seed)
    mod = torch_cls(cfg_t, device="cpu", dtype=torch.float32)
    mod.load_state_dict({k: to_tensor(v, "cpu") for k, v in pn.items()}, strict=True)
    return jax.tree.map(jnp.asarray, pn), mod


def rand(seed, shape, scale=0.5):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def jax_state_np(st):
    return jax.tree.map(np.asarray, st)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


class TestMamba2:
    def setup_method(self):
        self.cfg_j, self.cfg_t = cfg_pair("zamba2-7b")
        self.pj, self.pt = module_pair(jax_mamba2.init_mamba2, mamba2.Mamba2, self.cfg_j,
                                       self.cfg_t)

    @pytest.mark.parametrize("S,chunk", [(8, 4), (11, 4), (16, 16), (7, 32)])
    def test_forward_equals_jax(self, S, chunk):
        x = rand(1, (B, S, self.cfg_t.d_model))
        yj, stj = jax_mamba2.mamba2_forward(self.pj, jnp.asarray(x), self.cfg_j, chunk=chunk)
        yt, stt = mamba2.mamba2_forward(self.pt, torch.from_numpy(x), self.cfg_t, chunk=chunk)
        close(yt, yj, 1e-4)
        close_tree(stt, jax_state_np(stj), 1e-4)

    def test_decode_steps_equal_jax_and_forward(self):
        S = 9
        x = rand(2, (B, S, self.cfg_t.d_model))
        stj = jax_mamba2.init_mamba_state(self.cfg_j, B, jnp.float32)
        stt = mamba2.init_mamba_state(self.cfg_t, B, "cpu", torch.float32)
        full, _ = mamba2.mamba2_forward(self.pt, torch.from_numpy(x), self.cfg_t, chunk=4)
        for t in range(S):
            yj, stj = jax_mamba2.mamba2_decode_step(self.pj, jnp.asarray(x[:, t]), stj,
                                                     self.cfg_j)
            yt, stt2 = mamba2.mamba2_decode_step(self.pt, torch.from_numpy(x[:, t]), stt,
                                                 self.cfg_t)
            assert stt2 is stt  # updated in place
            close(yt, yj, 1e-4, msg=f"step {t}")
            close(yt, full[:, t], 1e-4, msg=f"step {t} vs chunked forward")
        close_tree(stt, jax_state_np(stj), 1e-4)

    def test_state_continuation(self):
        """forward(x1) then forward(x2, state) == forward(concat), as JAX."""
        x = torch.from_numpy(rand(3, (1, 12, self.cfg_t.d_model)))
        y_all, st_all = mamba2.mamba2_forward(self.pt, x, self.cfg_t, chunk=4)
        y1, st = mamba2.mamba2_forward(self.pt, x[:, :5], self.cfg_t, chunk=4)
        y2, st2 = mamba2.mamba2_forward(self.pt, x[:, 5:], self.cfg_t, chunk=4, state=st)
        close(torch.cat([y1, y2], 1), y_all.numpy(), 1e-4)
        close_tree(st2, {k: v.numpy() for k, v in st_all.items()}, 1e-4)

    def test_causal_conv_equals_jax(self):
        x, w = rand(4, (B, 6, 16)), rand(5, (4, 16))
        prior = rand(6, (B, 3, 16))
        close(mamba2._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                                  torch.from_numpy(prior)),
              jax_mamba2._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(prior)),
              1e-6)

    def test_long_chunk_has_no_overflow(self):
        """A chunk whose decay above the diagonal overflows exp (dt summed
        past ~88 inside one chunk) still gives finite, causal outputs: the
        masked entries are zeroed, never multiplied as inf by 0."""
        x = torch.from_numpy(rand(7, (1, 160, self.cfg_t.d_model)))
        with torch.no_grad():
            self.pt.dt_bias.fill_(2.0)  # dt ~ 2 a step: ~320 summed over the chunk
        y, st = mamba2.mamba2_forward(self.pt, x, self.cfg_t, chunk=160)
        y4, _ = mamba2.mamba2_forward(self.pt, x, self.cfg_t, chunk=4)
        assert torch.isfinite(y).all() and torch.isfinite(st["h"]).all()
        close(y, y4.numpy(), 1e-4)


class TestXLSTM:
    def setup_method(self):
        self.cfg_j, self.cfg_t = cfg_pair("xlstm-1.3b")

    def _mlstm(self):
        return module_pair(jax_xlstm.init_mlstm, xlstm.MLSTM, self.cfg_j, self.cfg_t)

    def _slstm(self):
        return module_pair(jax_xlstm.init_slstm, xlstm.SLSTM, self.cfg_j, self.cfg_t, seed=1)

    @pytest.mark.parametrize("S,chunk", [(8, 4), (11, 4), (9, 16)])
    def test_mlstm_forward_equals_jax(self, S, chunk):
        pj, pt = self._mlstm()
        x = rand(1, (B, S, self.cfg_t.d_model))
        yj, stj = jax_xlstm.mlstm_forward(pj, jnp.asarray(x), self.cfg_j, chunk=chunk)
        yt, stt = xlstm.mlstm_forward(pt, torch.from_numpy(x), self.cfg_t, chunk=chunk)
        close(yt, yj, 2e-4)
        close_tree(stt, jax_state_np(stj), 2e-4)

    def test_mlstm_decode_steps_equal_jax_and_forward(self):
        pj, pt = self._mlstm()
        S = 9
        x = rand(2, (B, S, self.cfg_t.d_model))
        full, _ = xlstm.mlstm_forward(pt, torch.from_numpy(x), self.cfg_t, chunk=4)
        stj = jax_xlstm.init_mlstm_state(self.cfg_j, B, jnp.float32)
        stt = xlstm.init_mlstm_state(self.cfg_t, B, "cpu", torch.float32)
        for t in range(S):
            yj, stj = jax_xlstm.mlstm_decode_step(pj, jnp.asarray(x[:, t]), stj, self.cfg_j)
            yt, _ = xlstm.mlstm_decode_step(pt, torch.from_numpy(x[:, t]), stt, self.cfg_t)
            close(yt, yj, 2e-4, msg=f"step {t}")
            close(yt, full[:, t], 2e-4, msg=f"step {t} vs chunked forward")
        close_tree(stt, jax_state_np(stj), 2e-4)

    def test_mlstm_state_continuation(self):
        _, pt = self._mlstm()
        x = torch.from_numpy(rand(3, (1, 11, self.cfg_t.d_model)))
        y_all, _ = xlstm.mlstm_forward(pt, x, self.cfg_t, chunk=4)
        y1, st = xlstm.mlstm_forward(pt, x[:, :6], self.cfg_t, chunk=4)
        y2, _ = xlstm.mlstm_forward(pt, x[:, 6:], self.cfg_t, chunk=4, state=st)
        close(torch.cat([y1, y2], 1), y_all.numpy(), 2e-4)

    def test_slstm_forward_equals_jax(self):
        pj, pt = self._slstm()
        x = rand(4, (B, 9, self.cfg_t.d_model))
        yj, stj = jax_xlstm.slstm_forward(pj, jnp.asarray(x), self.cfg_j)
        yt, stt = xlstm.slstm_forward(pt, torch.from_numpy(x), self.cfg_t)
        close(yt, yj, 2e-4)
        close_tree(stt, jax_state_np(stj), 2e-4)

    def test_slstm_decode_steps_equal_jax_and_forward(self):
        pj, pt = self._slstm()
        S = 7
        x = rand(5, (B, S, self.cfg_t.d_model))
        full, _ = xlstm.slstm_forward(pt, torch.from_numpy(x), self.cfg_t)
        stj = jax_xlstm.init_slstm_state(self.cfg_j, B)
        stt = xlstm.init_slstm_state(self.cfg_t, B, "cpu")
        for t in range(S):
            yj, stj = jax_xlstm.slstm_decode_step(pj, jnp.asarray(x[:, t]), stj, self.cfg_j)
            yt, _ = xlstm.slstm_decode_step(pt, torch.from_numpy(x[:, t]), stt, self.cfg_t)
            close(yt, yj, 2e-4, msg=f"step {t}")
            close(yt, full[:, t], 2e-4, msg=f"step {t} vs scan")
        close_tree(stt, jax_state_np(stj), 2e-4)

    def test_mlstm_long_rollout_stays_finite(self):
        """The stabiliser holds over 200 decode steps (as the reference's test)."""
        _, pt = self._mlstm()
        st = xlstm.init_mlstm_state(self.cfg_t, 1, "cpu", torch.float32)
        x = torch.from_numpy(rand(6, (1, self.cfg_t.d_model), 1.0))
        for _ in range(200):
            y, st = xlstm.mlstm_decode_step(pt, x, st, self.cfg_t)
        assert torch.isfinite(y).all()

    @pytest.mark.parametrize("d,f", [(256, 384), (2048, 2816), (100, 256)])
    def test_slstm_ffn_dim(self, d, f):
        cfg = dataclasses.replace(self.cfg_t, d_model=d)
        assert xlstm.slstm_ffn_dim(cfg) == f == jax_xlstm.slstm_ffn_dim(
            dataclasses.replace(self.cfg_j, d_model=d))


# ---------------------------------------------------------------------------
# stacks
# ---------------------------------------------------------------------------


def pair(case):
    """(jax model, jax params, port model, port params) on the same weights."""
    if case not in _PAIRS:
        arch, kw = CASES[case]
        cfg_j, cfg_t = cfg_pair(arch, **kw)
        mj = jax_build_model(cfg_j, JaxFlags(remat=False))
        pj, _ = mj.init(jax.random.PRNGKey(0))
        pn = perturbed(pj, seed=list(CASES).index(case))
        mt = build_model(cfg_t)
        _PAIRS[case] = (mj, jax.tree.map(jnp.asarray, pn), mt,
                        convert_params(pn, cfg_t, device="cpu"))
    return _PAIRS[case]


def tokens(cfg, seq, seed=0, batch=B):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)


def pad_jax_cache(cache, n):
    cache = dict(cache)
    if "k" in cache:
        for k in ("k", "v"):
            cache[k] = jnp.pad(cache[k], ((0, 0), (0, 0), (0, n), (0, 0), (0, 0)))
        cache["pos"] = jnp.pad(cache["pos"], ((0, 0), (0, n)), constant_values=-1)
    return cache


def pad_cache(cache, n):
    cache = dict(cache)
    if "k" in cache:
        for k in ("k", "v"):
            cache[k] = torch.nn.functional.pad(cache[k], (0, 0, 0, 0, 0, n))
        cache["pos"] = torch.nn.functional.pad(cache["pos"], (0, n), value=-1)
    return cache


@pytest.mark.parametrize("case", list(CASES))
class TestStacksAgainstJax:
    def test_group_shape(self, case):
        _, _, mt, pt = pair(case)
        ng, gs, rem = group_shape(mt.cfg)
        assert ng * gs + rem == mt.cfg.n_layers
        if mt.cfg.family == "hybrid":
            assert len(pt.mamba_groups) == ng and len(pt.mamba_rest) == rem
            assert all(len(g) == gs for g in pt.mamba_groups)
        else:
            assert len(pt.mlstm_groups) == len(pt.slstm_blocks) == ng
            assert all(len(g) == gs - 1 for g in pt.mlstm_groups)

    def test_forward(self, case):
        mj, pj, mt, pt = pair(case)
        x = tokens(mt.cfg, S)
        lj, _ = mj.forward(pj, jnp.asarray(x))
        lt, aux = mt.forward(pt, torch.from_numpy(x))
        assert lt.shape == lj.shape and aux == {}
        close(lt, lj)

    def test_prefill(self, case):
        mj, pj, mt, pt = pair(case)
        x = tokens(mt.cfg, S, seed=1)
        lj, cj = mj.prefill(pj, jnp.asarray(x))
        lt, ct = mt.prefill(pt, torch.from_numpy(x))
        close(lt, lj)
        assert set(ct) == set(cj)
        close_tree({k: v for k, v in ct.items() if k != "pos"},
                   {k: jax_state_np(v) for k, v in cj.items() if k != "pos"}, TOL)
        if "pos" in cj:
            np.testing.assert_array_equal(ct["pos"].numpy(), np.asarray(cj["pos"]))

    def test_decode_steps(self, case):
        """Decode after prefill equals JAX's decode and the port's own forward."""
        mj, pj, mt, pt = pair(case)
        x = tokens(mt.cfg, S + EXTRA, seed=2)
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
        close_tree({k: v for k, v in ct.items() if k != "pos"},
                   {k: jax_state_np(v) for k, v in cj.items() if k != "pos"}, TOL)

    def test_converted_cache_decodes_same(self, case):
        """A JAX prefill cache converted by `convert_cache` decodes as the
        port's own prefill cache does."""
        mj, pj, mt, pt = pair(case)
        x = tokens(mt.cfg, S + 1, seed=3)
        _, cj = mj.prefill(pj, jnp.asarray(x[:, :S]))
        _, ct = mt.prefill(pt, torch.from_numpy(x[:, :S]))
        conv = pad_cache(convert_cache(jax_state_np(cj), device="cpu"), 1)
        pos = torch.full((B,), S, dtype=torch.int32)
        tok = torch.from_numpy(x[:, S])
        a, _ = mt.decode(pt, pad_cache(ct, 1), tok, pos)
        b, _ = mt.decode(pt, conv, tok, pos)
        close(a, b.numpy())

    def test_engine_greedy_equals_jax(self, case):
        mj, pj, mt, pt = pair(case)
        lengths = [6, 8, 6]
        rng = np.random.default_rng(10)
        ps = [rng.integers(0, mt.cfg.vocab_size, (n,)).astype(np.int32) for n in lengths]
        reqs = [GenRequest(uid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(ps)]
        ours = InferenceEngine(mt, pt, max_batch=2, max_seq=24, device="cpu").generate(reqs)
        theirs = JaxEngine(mj, pj, max_batch=2, max_seq=24).generate(
            [JaxRequest(uid=r.uid, prompt=jnp.asarray(r.prompt), max_new_tokens=4)
             for r in reqs])
        for r in reqs:
            assert ours[r.uid].tokens == theirs[r.uid].tokens, r.uid

    def test_batched_equals_sequential(self, case):
        _, _, mt, pt = pair(case)
        rng = np.random.default_rng(20)
        ps = [rng.integers(0, mt.cfg.vocab_size, (n,)).astype(np.int32) for n in (5, 9, 7)]
        reqs = [GenRequest(uid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(ps)]
        batched = InferenceEngine(mt, pt, max_batch=3, max_seq=24, device="cpu").generate(reqs)
        for r in reqs:
            solo = InferenceEngine(mt, pt, max_batch=1, max_seq=24, device="cpu").generate([r])
            assert solo[r.uid].tokens == batched[r.uid].tokens, r.uid


class TestStackDetails:
    def test_chunked_scans_equal_one_chunk(self):
        """The stacks' chunk lengths (RuntimeFlags) change no result."""
        for case in ("zamba2-rem", "xlstm-2groups"):
            _, _, mt, pt = pair(case)
            x = torch.from_numpy(tokens(mt.cfg, S, seed=4))
            small = build_model(mt.cfg, RuntimeFlags(mamba_chunk=4, mlstm_chunk=5))
            a, _ = mt.forward(pt, x)
            b, _ = small.forward(pt, x)
            close(b, a.numpy(), 1e-4, msg=case)

    def test_hybrid_decode_counts_kernel_calls(self):
        """zamba2's launch identity on the CPU path's dispatch: per forward,
        2 L + 2 ng + 1 rmsnorm calls and ng attention calls."""
        from repro_torch.kernels import ops

        _, _, mt, pt = pair("zamba2-rem")
        ng, _, _ = group_shape(mt.cfg)
        L = mt.cfg.n_layers
        calls = {"rmsnorm": 0, "attn": 0}
        saved = (ops.rmsnorm, ops.flash_attention, ops.decode_attention)

        def count(name, fn):
            def call(*a, **k):
                calls[name] += 1
                return fn(*a, **k)
            return call

        ops.rmsnorm = count("rmsnorm", saved[0])
        ops.flash_attention = count("attn", saved[1])
        ops.decode_attention = count("attn", saved[2])
        try:
            flags = RuntimeFlags(attention_impl="pallas")  # the kernel's dispatch on the CPU
            m = build_model(mt.cfg, flags)
            _, cache = m.prefill(pt, torch.from_numpy(tokens(mt.cfg, 6, seed=5)))
            cache = pad_cache(cache, 1)
            m.decode(pt, cache, torch.zeros(B, dtype=torch.long),
                     torch.full((B,), 6, dtype=torch.int32))
        finally:
            ops.rmsnorm, ops.flash_attention, ops.decode_attention = saved
        assert calls == {"rmsnorm": 2 * (2 * L + 2 * ng + 1), "attn": 2 * ng}

    @pytest.mark.parametrize("case", ["zamba2-rem", "xlstm-2groups"])
    def test_rmsnorm_inputs_are_rows_of_one_stride(self, case, monkeypatch):
        """The rmsnorm kernel takes rows one stride apart (`x.view(-1, d)`):
        every norm of the stacks, padded chunks and batch 2 included, hands
        it such rows (the CPU path would take any layout)."""
        from repro_torch.kernels import ops

        plain = ops.rmsnorm

        def card_layout(x, gamma, eps=1e-5):
            x.view(-1, x.shape[-1])  # raises as the card's wrapper does
            return plain(x, gamma, eps)

        monkeypatch.setattr(ops, "rmsnorm", card_layout)
        _, _, mt, pt = pair(case)
        chunked = build_model(mt.cfg, RuntimeFlags(mamba_chunk=5, mlstm_chunk=5))
        x = torch.from_numpy(tokens(mt.cfg, S, seed=7))
        chunked.forward(pt, x)
        _, cache = chunked.prefill(pt, x)
        chunked.decode(pt, pad_cache(cache, 1), x[:, 0], torch.full((B,), S, dtype=torch.int32))

    def test_slstm_ffn_norm_is_kept_and_unread(self):
        """The reference's tree holds `ffn_norm`, which its stack never reads:
        conversion keeps the leaf, and changing it changes nothing."""
        _, _, mt, pt = pair("xlstm-1.3b")
        assert "slstm_blocks.0.ffn_norm" in pt.state_dict()
        x = torch.from_numpy(tokens(mt.cfg, 6, seed=6))
        a, _ = mt.forward(pt, x)
        saved = pt.slstm_blocks[0].ffn_norm.clone()
        with torch.no_grad():
            pt.slstm_blocks[0].ffn_norm.mul_(3.0)
        b, _ = mt.forward(pt, x)
        with torch.no_grad():
            pt.slstm_blocks[0].ffn_norm.copy_(saved)
        assert torch.equal(a, b)

    @pytest.mark.parametrize("case", ["zamba2-rem", "xlstm-2groups"])
    def test_convert_params_is_strict(self, case):
        """A leaf missing from the JAX tree, or one the port lacks, raises."""
        mj, _, mt, _ = pair(case)
        pj, _ = mj.init(jax.random.PRNGKey(1))
        pn = jax.tree.map(np.asarray, pj)
        top = "mamba_groups" if mt.cfg.family == "hybrid" else "mlstm_groups"
        leaf = next(iter(pn[top]))
        missing = dict(pn, **{top: {k: v for k, v in pn[top].items() if k != leaf}})
        with pytest.raises(RuntimeError, match="Missing key"):
            convert_params(missing, mt.cfg, device="cpu")
        extra = dict(pn, bogus=np.zeros(3, np.float32))
        with pytest.raises(RuntimeError, match="Unexpected key"):
            convert_params(extra, mt.cfg, device="cpu")

    def test_init_cache_matches_jax_layout(self):
        for case in ("zamba2-rem", "xlstm-2groups"):
            mj, _, mt, _ = pair(case)
            cj, _ = mj.init_cache(3, 10)
            ct = mt.init_cache(3, 10, device="cpu")
            close_tree(ct, jax_state_np(cj), 0.0)

    def test_random_init_runs(self):
        """The port's own initialisation (not converted weights) at smoke size."""
        for case in ("zamba2-rem", "xlstm-2groups"):
            _, _, mt, _ = pair(case)
            p = mt.init(seed=0, device="cpu")
            lg, _ = mt.forward(p, torch.from_numpy(tokens(mt.cfg, 5)))
            assert torch.isfinite(lg).all()
            blk = p.mamba_groups[0][0].mamba if case.startswith("zamba2") else \
                p.mlstm_groups[0][0].mlstm
            assert float(blk.norm.min()) == float(blk.norm.max()) == 1.0
