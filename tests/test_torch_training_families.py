"""Training the hybrid (zamba2), ssm (xlstm) and enc-dec (seamless-m4t)
families in the port against the JAX package on the CPU.

Modules first: `jax.vjp` of `mamba2_forward` over several chunks of at most
64 steps, `mlstm_forward` over several chunks, `slstm_forward` and enc-dec
cross attention, each gradient against the port's `torch.autograd.grad` on
the same weights, inputs and cotangents; then Mamba2's long-chunk gradient
(finite at chunks of 160 and 256, equal to chunks of 4; the reference is
NaN there already in the forward). Then the loss and every gradient leaf of
each family against `jax.value_and_grad(Model.loss)`, remat on and off,
with a zamba2 remainder group and two xlstm groups; AdamW's decay mask on
these trees; two enc-dec microbatches against one; checkpoints across the
packages both ways; `launch.train` for each family; serving recording no
graph; and bf16's departure from the f32 gradient, no larger in the port
than in the reference.

Weights come from the reference's `Model.init` with its constant leaves
(norms, biases, dt_bias, A_log, D, skip) overwritten by seeded values and
are carried over by `convert_params`; inputs are made by numpy from a seed.
Tolerances: the loss at the model-level 2e-3 (tests/test_consistency.py),
each gradient leaf at 2e-4 of its largest magnitude, module gradients at the
modules' forward bars (Mamba2 1e-4, xLSTM 2e-4; tests/test_torch_ssm.py)
taken of the largest magnitude, the optimizer at 1e-6.
"""

import dataclasses
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.training as jtrain  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import RuntimeFlags as JaxFlags  # noqa: E402
from repro.models import attention as jax_attention  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import mamba2 as jax_mamba2  # noqa: E402
from repro.models import xlstm as jax_xlstm  # noqa: E402
from repro.models.common import Initializer  # noqa: E402
from repro_torch import training  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    convert_params, export_params, reference_rank, restack, to_numpy, to_tensor)
from repro_torch.models import RuntimeFlags, attention, build_model, mamba2, xlstm  # noqa: E402
from repro_torch.models.rope import rope_tables  # noqa: E402

LOSS_TOL, GRAD_TOL, OPT_TOL = 2e-3, 2e-4, 1e-6
MAMBA_TOL, XLSTM_TOL = 1e-4, 2e-4
B, S, SE = 2, 12, 7  # batch, sequence (decoder) length, encoder frames
# case: (arch, fields replaced on its smoke config, RuntimeFlags fields of both packages)
CASES = {
    # one group of 2 Mamba2 layers and the shared block; default chunk (one chunk of 12)
    "zamba2-7b": ("zamba2-7b", {}, {}),
    # 2 groups of 2 and a remainder layer; chunks of 4 (3 chunks a layer)
    "zamba2-rem": ("zamba2-7b", {"n_layers": 5}, {"mamba_chunk": 4}),
    # one group: an mLSTM and an sLSTM block; default chunk
    "xlstm-1.3b": ("xlstm-1.3b", {}, {}),
    # two groups; chunks of 5 (ragged last chunk)
    "xlstm-2groups": ("xlstm-1.3b", {"n_layers": 4}, {"mlstm_chunk": 5}),
    "seamless-m4t": ("seamless-m4t-large-v2", {}, {}),
}
PERTURB = {  # leaf -> (offset, scale): seeded values where the init is constant
    "norm": (1.0, 0.1), "attn_norm": (1.0, 0.1), "mlp_norm": (1.0, 0.1),
    "final_norm": (1.0, 0.1), "enc_final_norm": (1.0, 0.1), "ffn_norm": (1.0, 0.1),
    "self_norm": (1.0, 0.1), "cross_norm": (1.0, 0.1), "D": (1.0, 0.1), "skip": (1.0, 0.1),
    "dt_bias": (0.0, 0.3), "A_log": (0.0, 0.3), "b_if": (0.0, 0.3), "b_gates": (0.0, 0.3),
}


def rand(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


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


def leaves_with_paths(tree):
    """[(path string, numpy leaf)] of a nested dict, in jax's order."""
    return [("/".join(str(getattr(k, "key", k)) for k in p), np.asarray(v))
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]]


def assert_leaves_close(got, want, tol, what):
    """Two nested dicts with the same leaves, each within tol of the
    reference leaf's largest magnitude."""
    g, w = leaves_with_paths(got), leaves_with_paths(want)
    assert [p for p, _ in g] == [p for p, _ in w], what
    for (path, a), (_, b) in zip(g, w):
        assert np.isfinite(a).all(), f"{what} {path}: non-finite"
        scale = max(float(np.abs(b).max()), 1e-30)
        err = float(np.abs(a.astype(np.float32) - b.astype(np.float32)).max())
        assert err <= tol * scale, f"{what} {path}: max|err| {err:.3g} > {tol} x {scale:.3g}"


def assert_close_of_largest(got, want, tol, what):
    """One array within tol of the reference's largest magnitude."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert np.isfinite(got).all(), f"{what}: non-finite"
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max|err| {err:.3g} > {tol} x {scale:.3g}"


def cfg_pair(arch, **kw):
    cj = dataclasses.replace(jax_get_config(arch, smoke=True), dtype="float32", **kw)
    ct = dataclasses.replace(get_config(arch, smoke=True), dtype="float32", **kw)
    return cj, ct


def make_batch(cfg, seed=12, batch=B):
    """The loss's batch as numpy: tokens/labels, and for enc-dec SE encoder
    frames, the decoder tokens and the labels."""
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (batch, S + 1)).astype(np.int32)
    out = {"labels": toks[:, 1:]}
    if cfg.n_encoder_layers:
        out["enc_embeds"] = rand(seed + 1, (batch, SE, cfg.d_model), scale=0.5)
        out["dec_tokens"] = toks[:, :-1]
    else:
        out["tokens"] = toks[:, :-1]
    return out


_JAX = {}


def jax_pair(case):
    """(port config, flags, reference params as numpy (perturbed), batch,
    reference loss, reference grads), cached per case."""
    if case not in _JAX:
        arch, kw, flags = CASES[case]
        cfg_j, cfg = cfg_pair(arch, **kw)
        mj = jax_build_model(cfg_j, JaxFlags(remat=False, **flags))
        pj = jax.jit(lambda k: mj.init(k)[0])(jax.random.PRNGKey(0))  # one compile
        pn = perturbed(pj, seed=11)
        batch = make_batch(cfg)
        (lj, _), gj = jax.jit(jax.value_and_grad(mj.loss, has_aux=True))(
            jax.tree.map(jnp.asarray, pn), {k: jnp.asarray(v) for k, v in batch.items()})
        _JAX[case] = (cfg, flags, pn, batch, float(lj), jax.tree.map(np.asarray, gj))
    return _JAX[case]


def port_loss_and_grads(cfg, pn, batch, **flags):
    model = build_model(cfg, RuntimeFlags(**flags))
    params = convert_params(pn, cfg, device="cpu").requires_grad_(True)
    loss, aux = model.loss(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    names, leaves = zip(*params.named_parameters())
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    return float(loss.detach()), aux, jax.tree.map(to_numpy, restack(dict(zip(names, grads))))


def module_pair(jax_init, torch_cls, cfg_j, cfg_t, seed=0):
    """(jax params, port module requiring grad) of one block on the same
    perturbed weights."""
    pn = perturbed(jax_init(Initializer(jax.random.PRNGKey(seed), jnp.float32), cfg_j), seed)
    mod = torch_cls(cfg_t, device="cpu", dtype=torch.float32)
    mod.load_state_dict({k: to_tensor(v, "cpu") for k, v in pn.items()}, strict=True)
    return jax.tree.map(jnp.asarray, pn), mod.requires_grad_(True)


def vjp_against_jax(jax_fn, pj, port_fn, mod, x, cotangents, tol, what):
    """The gradient of sum(cotangent * output) over the block's parameters
    and its input x, in both packages. `jax_fn(p, x)` and `port_fn(mod, x)`
    return the same tuple of arrays; `cotangents` matches it."""
    outs_j, vjp = jax.vjp(jax.jit(jax_fn), pj, jnp.asarray(x))
    dpj, dxj = vjp(tuple(jnp.asarray(c) for c in cotangents))
    xt = torch.from_numpy(x).requires_grad_(True)
    outs_t = port_fn(mod, xt)
    for k, (a, b) in enumerate(zip(outs_t, outs_j)):
        assert_close_of_largest(a, b, tol, f"{what} output {k}")
    names, leaves = zip(*mod.named_parameters())
    grads = torch.autograd.grad(outs_t, (xt, *leaves),
                                tuple(torch.from_numpy(c) for c in cotangents))
    assert_close_of_largest(grads[0], dxj, tol, f"{what} dx")
    for name, g in zip(names, grads[1:]):
        assert_close_of_largest(g, dpj[name], tol, f"{what} d{name}")


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


class TestModuleGradients:
    @pytest.mark.parametrize("S_,chunk", [(20, 8), (11, 4), (64, 64), (70, 64)])
    def test_mamba2_forward_vjp(self, S_, chunk):
        """Several chunks (and a padded last one), the output and the final
        state h both carrying a cotangent: the state buffer written chunk
        by chunk (`y_inter[:, c] = ...`) passes its gradient."""
        cfg_j, cfg_t = cfg_pair("zamba2-7b")
        pj, pt = module_pair(jax_mamba2.init_mamba2, mamba2.Mamba2, cfg_j, cfg_t)
        x = rand(1, (B, S_, cfg_t.d_model), 0.5)
        h_shape = (B, cfg_t.n_ssm_heads, cfg_t.ssm_head_dim, cfg_t.ssm_state)
        cot = (rand(2, (B, S_, cfg_t.d_model)), rand(3, h_shape))
        vjp_against_jax(
            lambda p, a: (lambda y, st: (y, st["h"]))(
                *jax_mamba2.mamba2_forward(p, a, cfg_j, chunk=chunk)),
            pj,
            lambda m, a: (lambda y, st: (y, st["h"]))(
                *mamba2.mamba2_forward(m, a, cfg_t, chunk=chunk)),
            pt, x, cot, MAMBA_TOL, f"mamba2 S={S_} chunk={chunk}")

    @pytest.mark.parametrize("S_,chunk", [(11, 4), (12, 4), (9, 16)])
    def test_mlstm_forward_vjp(self, S_, chunk):
        """The chunk loop writes `hs[:, c]` and carries (C, n, m) through
        torch.maximum and amax, whose ties split as jnp.maximum's and
        jnp.max's; cotangents on the output and the final C and n."""
        cfg_j, cfg_t = cfg_pair("xlstm-1.3b")
        pj, pt = module_pair(jax_xlstm.init_mlstm, xlstm.MLSTM, cfg_j, cfg_t)
        x = rand(4, (B, S_, cfg_t.d_model), 0.5)
        nh, P = cfg_t.n_heads, cfg_t.d_inner // cfg_t.n_heads
        cot = (rand(5, (B, S_, cfg_t.d_model)), rand(6, (B, nh, P, P)), rand(7, (B, nh, P)))

        def pick(y, st):
            return y, st["C"], st["n"]

        vjp_against_jax(
            lambda p, a: pick(*jax_xlstm.mlstm_forward(p, a, cfg_j, chunk=chunk)), pj,
            lambda m, a: pick(*xlstm.mlstm_forward(m, a, cfg_t, chunk=chunk)), pt,
            x, cot, XLSTM_TOL, f"mlstm S={S_} chunk={chunk}")

    def test_slstm_forward_vjp(self):
        cfg_j, cfg_t = cfg_pair("xlstm-1.3b")
        pj, pt = module_pair(jax_xlstm.init_slstm, xlstm.SLSTM, cfg_j, cfg_t, seed=1)
        x = rand(8, (B, 9, cfg_t.d_model), 0.5)
        cot = (rand(9, (B, 9, cfg_t.d_model)), rand(10, (B, cfg_t.d_model)))

        def pick(y, st):
            return y, st["c"]

        vjp_against_jax(lambda p, a: pick(*jax_xlstm.slstm_forward(p, a, cfg_j)), pj,
                        lambda m, a: pick(*xlstm.slstm_forward(m, a, cfg_t)), pt,
                        x, cot, XLSTM_TOL, "slstm")

    def test_slstm_saves_no_weight_copy_a_step(self):
        """The recurrent product reads r_gates in place: what autograd saves
        grows by activations a time step, not by a copy of the weights (a
        product broadcast over the batch saved B x r_gates a step: 34 GB
        over xlstm-1.3b's 512 steps at batch 4)."""
        cfg = dataclasses.replace(get_config("xlstm-1.3b", smoke=True), dtype="float32",
                                  d_model=512)
        p = xlstm.init_slstm(xlstm.SLSTM(cfg, device="cpu", dtype=torch.float32),
                             torch.Generator().manual_seed(0)).requires_grad_(True)

        def saved_bytes(steps):
            seen = {}

            def pack(t):
                seen[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
                return t

            x = torch.from_numpy(rand(17, (B, steps, cfg.d_model), 0.5))
            with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
                xlstm.slstm_forward(p, x, cfg)
            return sum(seen.values())

        per_step = (saved_bytes(16) - saved_bytes(8)) / 8
        activations = B * 4 * cfg.d_model * 4  # one (B, 4d) f32 tensor
        assert per_step <= 16 * activations < B * p.r_gates.numel() * 4, per_step

    @pytest.mark.parametrize("impl", ["naive", "chunked"])
    def test_cross_attention_vjp(self, impl):
        """Queries from the decoder, K/V projected from the encoder output:
        the gradient reaches both inputs and every projection."""
        cfg_j, cfg_t = cfg_pair("seamless-m4t-large-v2", qkv_bias=True)
        mj = jax_build_model(cfg_j, JaxFlags())
        pn = perturbed(mj.init(jax.random.PRNGKey(0))[0], seed=3)
        rng = np.random.default_rng(13)
        for k in ("bq", "bk", "bv"):
            a = pn["dec_layers"]["cross_attn"][k]
            pn["dec_layers"]["cross_attn"][k] = (0.1 * rng.standard_normal(a.shape)).astype(
                np.float32)
        lj = jax.tree.map(lambda a: jnp.asarray(a[0]), pn["dec_layers"]["cross_attn"])
        lt = attention.Attention(cfg_t, device="cpu", dtype=torch.float32)
        lt.load_state_dict({k: to_tensor(v[0], "cpu")
                            for k, v in pn["dec_layers"]["cross_attn"].items()})
        lt.requires_grad_(True)
        x, mem = rand(14, (B, S, cfg_t.d_model)), rand(15, (B, SE, cfg_t.d_model))
        pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
        epos = np.broadcast_to(np.arange(SE, dtype=np.int32), (B, SE))
        dy = rand(16, (B, S, cfg_t.d_model))

        def fj(p, a, m):
            return jax_attention.attention_forward(
                p, a, cfg_j, JaxFlags(), jnp.asarray(pos),
                cross_kv=jax_attention.project_kv(p, m, cfg_j), cross_pos=jnp.asarray(epos))[0]

        yj, vjp = jax.vjp(jax.jit(fj), lj, jnp.asarray(x), jnp.asarray(mem))
        dpj, dxj, dmj = vjp(jnp.asarray(dy))
        rt = RuntimeFlags(attention_impl=impl, q_chunk=5, kv_chunk=3)
        xt, mt = (torch.from_numpy(a).requires_grad_(True) for a in (x, mem))
        tpos = torch.from_numpy(pos.copy())
        yt, _ = attention.attention_forward(
            lt, xt, cfg_t, rt, tpos, rope_tables(tpos, cfg_t.head_dim, cfg_t.rope_theta),
            cross_kv=attention.project_kv(lt, mt), cross_pos=torch.from_numpy(epos.copy()))
        assert_close_of_largest(yt, yj, MAMBA_TOL, "cross attention output")
        names, leaves = zip(*lt.named_parameters())
        grads = torch.autograd.grad(yt, (xt, mt, *leaves), torch.from_numpy(dy))
        assert_close_of_largest(grads[0], dxj, MAMBA_TOL, "cross attention dx")
        assert_close_of_largest(grads[1], dmj, MAMBA_TOL, "cross attention d(encoder out)")
        dp = dict(zip(names, grads[2:]))
        # a key bias adds q . bk to every score of a row, which softmax
        # cancels: its gradient is 0 but for rounding, in both packages
        bk_floor = MAMBA_TOL * float(np.abs(np.asarray(dpj["bq"])).max())
        assert float(dp.pop("bk").abs().max()) <= bk_floor
        assert float(np.abs(np.asarray(dpj["bk"])).max()) <= bk_floor
        for name, g in dp.items():
            assert_close_of_largest(g, dpj[name], MAMBA_TOL, f"cross attention d{name}")


class TestMamba2LongChunkGradient:
    @pytest.mark.parametrize("chunk", [160, 256])
    def test_finite_and_equal_to_short_chunks(self, chunk):
        """dt ~ 2 a step sums past exp's f32 range (~88) inside one chunk:
        the exponent is masked before exp, so the masked entries and their
        gradients are exactly 0 (the product masked after exp gave 0 * inf =
        NaN in the backward). The gradient equals chunks of 4 on the same
        input, at the forward test's tolerance."""
        cfg_j, cfg_t = cfg_pair("zamba2-7b")
        _, pt = module_pair(jax_mamba2.init_mamba2, mamba2.Mamba2, cfg_j, cfg_t)
        with torch.no_grad():
            pt.dt_bias.fill_(2.0)
        x = torch.from_numpy(rand(7, (1, 256, cfg_t.d_model), 0.5))
        dy = torch.from_numpy(rand(8, (1, 256, cfg_t.d_model)))
        names, leaves = zip(*pt.named_parameters())
        out = []
        for c in (chunk, 4):
            xt = x.clone().requires_grad_(True)
            y, st = mamba2.mamba2_forward(pt, xt, cfg_t, chunk=c)
            out.append((y, torch.autograd.grad(y, (xt, *leaves), dy)))
        (y, g), (y4, g4) = out
        assert torch.isfinite(y).all()
        np.testing.assert_allclose(y.detach().numpy(), y4.detach().numpy(), rtol=MAMBA_TOL,
                                   atol=MAMBA_TOL)
        for name, a, b in zip(("x",) + names, g, g4):
            assert int(torch.isnan(a).sum()) == 0 and torch.isfinite(a).all(), name
            assert_close_of_largest(a, b.numpy(), MAMBA_TOL, f"d{name} chunk {chunk} vs 4")


# ---------------------------------------------------------------------------
# the loss and every gradient leaf
# ---------------------------------------------------------------------------


class TestLossAndGradients:
    @pytest.mark.parametrize("remat", [True, False])
    @pytest.mark.parametrize("case", list(CASES))
    def test_against_jax_value_and_grad(self, case, remat):
        cfg, flags, pn, batch, lj, gj = jax_pair(case)
        lt, aux, gt = port_loss_and_grads(cfg, pn, batch, remat=remat, **flags)
        assert abs(lt - lj) <= LOSS_TOL * max(1.0, abs(lj)), (lt, lj)
        assert aux == {}
        assert_leaves_close(gt, gj, GRAD_TOL, f"{case} grads")

    def test_unread_slstm_ffn_norm_gets_zero_gradient(self):
        cfg, flags, pn, batch, _, gj = jax_pair("xlstm-2groups")
        _, _, gt = port_loss_and_grads(cfg, pn, batch, **flags)
        assert not np.abs(gt["slstm_blocks"]["ffn_norm"]).any()
        assert not np.abs(np.asarray(gj["slstm_blocks"]["ffn_norm"])).any()

    @pytest.mark.parametrize("arch", ["zamba2-7b", "xlstm-1.3b", "seamless-m4t-large-v2"])
    def test_remat_checkpoints_each_group(self, arch, monkeypatch):
        """Under remat the stack checkpoints what the reference's
        jax.checkpoint wraps: zamba2's groups (not the remainder), xlstm's
        groups, and each encoder and decoder layer; none without remat or
        without a gradient."""
        from repro_torch.models import encdec, transformer

        cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32",
                                  **({"n_layers": 5} if arch == "zamba2-7b" else {}))
        calls = []
        for mod in (transformer, encdec):
            real = mod.checkpoint
            monkeypatch.setattr(mod, "checkpoint", lambda fn, *a, _r=real, **k: (
                calls.append(fn.__name__), _r(fn, *a, **k))[1])
        batch = {k: torch.from_numpy(v) for k, v in make_batch(cfg).items()}
        for remat in (True, False):
            model = build_model(cfg, RuntimeFlags(remat=remat))
            params = model.init(seed=0, device="cpu").requires_grad_(True)
            model.loss(params, batch)[0].backward()
            with torch.no_grad():
                model.loss(params, batch)
        want = {"zamba2-7b": ["_hybrid_group"] * 2, "xlstm-1.3b": ["_ssm_group"],
                "seamless-m4t-large-v2": ["_enc_layer"] * 2 + ["_dec_layer"] * 2}[arch]
        assert calls == want

    @pytest.mark.parametrize("remat", [True, False])
    @pytest.mark.parametrize("arch,cut", [
        ("zamba2-7b", {"n_layers": 7}),  # 3 groups of 2 and a remainder layer
        ("xlstm-1.3b", {"n_layers": 4}),
        ("seamless-m4t-large-v2", {"n_layers": 3, "n_encoder_layers": 2}),
        ("llama2-7b", {"n_layers": 3}),  # the uniform stack, as phase 7's llama2-7b
    ])
    def test_rmsnorm_calls_a_step(self, arch, cut, remat, monkeypatch):
        """rmsnorm forwards and backwards in one loss and gradient, counted
        here on the plain versions, are what `model.rmsnorm_calls` says and
        the card's launch counters read in `chip_smoke.py`: the forward's
        norms, again those remat recomputes, one backward a forward norm."""
        from repro_torch.kernels import ref
        from repro_torch.models.model import rmsnorm_calls

        cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32", **cut)
        norms, again = rmsnorm_calls(cfg)
        counts = {"fwd": 0, "bwd": 0}
        for name, key in (("rmsnorm", "fwd"), ("rmsnorm_bwd", "bwd")):
            real = getattr(ref, name)
            monkeypatch.setattr(ref, name, lambda *a, _r=real, _k=key, **k: (
                counts.__setitem__(_k, counts[_k] + 1), _r(*a, **k))[1])
        model = build_model(cfg, RuntimeFlags(remat=remat))
        params = model.init(seed=0, device="cpu").requires_grad_(True)
        batch = {k: torch.from_numpy(v) for k, v in make_batch(cfg).items()}
        model.loss(params, batch)[0].backward()
        assert counts == {"fwd": norms + (again if remat else 0), "bwd": norms}


class TestBf16Drift:
    @pytest.mark.parametrize("arch,n_layers,seq,flags", [
        ("zamba2-7b", 13, 256, {"mamba_chunk": 16}),  # 6 groups of 2 and a remainder
        ("xlstm-1.3b", 8, 128, {}),  # 4 groups
    ])
    def test_no_further_than_the_reference(self, arch, n_layers, seq, flags):
        """bf16 against f32 on the same weights (the reference's init, rounded
        to bf16) and tokens: the port's gradient departs from its f32
        gradient no further than the reference's bf16 gradient departs from
        its own, by each top-level part's cosine, within 0.01. The recurrent
        stacks amplify bf16's rounding in both packages (a cosine near 0.96
        for zamba2 here), which is why `chip_smoke.py` holds only the
        attention stacks' bf16 gradients to f32's. The reference runs
        chunks of 16: longer chunks are NaN there (ROADMAP §3)."""
        cfg_j, cfg_t = cfg_pair(arch, n_layers=n_layers)
        mj = jax_build_model(cfg_j, JaxFlags(remat=False, **flags))
        pj = jax.jit(lambda k: mj.init(k)[0])(jax.random.PRNGKey(0))
        pn = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32), pj)
        toks = np.random.default_rng(5).integers(0, cfg_t.vocab_size, (1, seq + 1))
        batch = {"tokens": toks[:, :-1].astype(np.int32), "labels": toks[:, 1:].astype(np.int32)}

        def by_part(flat):  # [(path, leaf)] -> {top-level part: flat f64 gradient}
            parts = {}
            for path, v in flat:
                parts.setdefault(path.split("/")[0], []).append(np.asarray(v, np.float64).ravel())
            return {k: np.concatenate(v) for k, v in parts.items()}

        grads = {}  # (package, dtype) -> by_part
        for dtype in ("float32", "bfloat16"):
            mj = jax_build_model(dataclasses.replace(cfg_j, dtype=dtype),
                                 JaxFlags(remat=False, **flags))
            g = jax.jit(jax.grad(lambda p, b: mj.loss(p, b)[0]))(
                jax.tree.map(lambda a: jnp.asarray(a, dtype), pn),
                {k: jnp.asarray(v) for k, v in batch.items()})
            grads["reference", dtype] = by_part(leaves_with_paths(g))
            model = build_model(dataclasses.replace(cfg_t, dtype=dtype), RuntimeFlags(**flags))
            params = convert_params(pn, cfg_t, device="cpu").to(getattr(torch, dtype))
            params.requires_grad_(True)
            loss, _ = model.loss(params, {k: torch.from_numpy(v) for k, v in batch.items()})
            names, leaves = zip(*params.named_parameters())
            gs = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
            grads["port", dtype] = by_part((n.replace(".", "/"), g.float().numpy())
                                           for n, g in zip(names, gs))
        cosines = {}
        for pkg in ("reference", "port"):
            a, b = grads[pkg, "bfloat16"], grads[pkg, "float32"]
            cosines[pkg] = {k: float(a[k] @ b[k] / np.sqrt((a[k] @ a[k]) * (b[k] @ b[k])))
                            for k in b}
        print(f"{arch}, {n_layers} layers, {seq} tokens, bf16 against f32 cosine by part: "
              f"{cosines}")
        assert cosines["port"].keys() == cosines["reference"].keys()
        for k, ref_cos in cosines["reference"].items():
            assert cosines["port"][k] >= ref_cos - 0.01, (k, cosines)


# ---------------------------------------------------------------------------
# optimizer, microbatches
# ---------------------------------------------------------------------------


class TestAdamWDecay:
    @pytest.mark.parametrize("case", ["zamba2-rem", "xlstm-2groups", "seamless-m4t"])
    def test_update_against_reference(self, case):
        """Three AdamW steps on identical gradients, the norms' gradients
        zero so decay alone moves them: the decay follows the reference
        leaf's rank, so the stacked norms decay (mamba_groups' (di,) norm,
        two stacked axes; slstm_blocks' unread ffn_norm) and the unstacked
        ones do not (shared.*, final_norm, enc_final_norm)."""
        cfg, _, pn, _, _, _ = jax_pair(case)
        oc_kw = dict(lr=1e-2, warmup_steps=1, total_steps=10, grad_clip=0.5)
        pj = jax.tree.map(jnp.asarray, pn)
        sj = jtrain.adamw_init(pj)
        pt = convert_params(pn, cfg, device="cpu")
        st = training.adamw_init(pt)
        names = [n for n, _ in pt.named_parameters()]
        update_j = jax.jit(jtrain.adamw_update, static_argnums=0)
        for step in range(3):
            rng = np.random.default_rng(20 + step)
            gn = jax.tree_util.tree_map_with_path(
                lambda path, a: np.zeros_like(a) if str(path[-1].key).endswith("norm")
                else rng.standard_normal(a.shape).astype(np.float32), pn)
            pj, sj, mj = update_j(jtrain.AdamWConfig(**oc_kw), pj,
                                  jax.tree.map(jnp.asarray, gn), sj)
            g_port = dict(convert_params(gn, cfg, device="cpu").named_parameters())
            pt, st, mt = training.adamw_update(training.AdamWConfig(**oc_kw), pt,
                                               {n: g_port[n].detach() for n in names}, st)
            for k in ("grad_norm", "lr"):
                assert abs(float(mt[k]) - float(mj[k])) <= OPT_TOL * abs(float(mj[k]))
        assert_leaves_close(export_params(pt), jax.tree.map(np.asarray, pj), OPT_TOL, "params")
        for k in ("mu", "nu"):
            assert_leaves_close(jax.tree.map(to_numpy, restack(st[k])),
                                jax.tree.map(np.asarray, sj[k]), OPT_TOL, k)
        named = dict(pt.named_parameters())
        decays = {"zamba2-rem": ["mamba_groups.1.0.norm", "mamba_groups.0.1.mamba.norm",
                                 "mamba_rest.0.norm", "mamba_rest.0.mamba.norm"],
                  "xlstm-2groups": ["mlstm_groups.1.0.mlstm.norm", "slstm_blocks.0.ffn_norm",
                                    "slstm_blocks.1.slstm.norm"],
                  "seamless-m4t": ["enc_layers.0.attn_norm", "dec_layers.1.cross_norm"]}[case]
        exempt = {"zamba2-rem": ["shared.attn_norm", "shared.mlp_norm", "final_norm"],
                  "xlstm-2groups": ["final_norm"],
                  "seamless-m4t": ["final_norm", "enc_final_norm"]}[case]
        start = dict(convert_params(pn, cfg, device="cpu").named_parameters())
        for n in decays:
            assert reference_rank(n, named[n]) >= 2, n
            assert float((named[n] - start[n]).abs().max()) > 1e-4, f"{n} did not decay"
        for n in exempt:
            assert reference_rank(n, named[n]) == 1, n
            assert torch.equal(named[n], start[n]), f"{n} decayed"


class TestEncDecTrainStep:
    def test_two_microbatches_equal_one(self):
        """All three enc-dec keys are sliced: two halves of a batch, their f32
        gradient sum halved, against the whole batch (the same loss, norm
        and first moment, to f32 rounding)."""
        cfg, _, pn, _, _, _ = jax_pair("seamless-m4t")
        model = build_model(cfg)
        batch = {k: torch.from_numpy(v) for k, v in make_batch(cfg, seed=30, batch=4).items()}
        out = []
        for mb in (1, 2):
            params = convert_params(pn, cfg, device="cpu").requires_grad_(True)
            step = training.make_train_step(model, training.AdamWConfig(lr=1e-2, warmup_steps=1),
                                            microbatches=mb)
            _, state, m = step(params, training.adamw_init(params), batch)
            out.append((state, m))
        (s1, m1), (s2, m2) = out
        assert abs(float(m1["loss"]) - float(m2["loss"])) <= 1e-6
        assert abs(float(m1["grad_norm"]) - float(m2["grad_norm"])) <= 1e-5 * float(m1["grad_norm"])
        assert_leaves_close(jax.tree.map(to_numpy, restack(s2["mu"])),
                            jax.tree.map(to_numpy, restack(s1["mu"])), 1e-5, "first moment")

    def test_microbatches_slice_every_key(self, monkeypatch):
        cfg, _, pn, _, _, _ = jax_pair("seamless-m4t")
        model = build_model(cfg)
        seen = []
        real = model.loss
        monkeypatch.setattr(type(model), "loss", lambda self, p, b: (
            seen.append({k: tuple(v.shape) for k, v in b.items()}), real(p, b))[1])
        batch = {k: torch.from_numpy(v) for k, v in make_batch(cfg, seed=31, batch=4).items()}
        params = convert_params(pn, cfg, device="cpu").requires_grad_(True)
        training.make_train_step(model, training.AdamWConfig(), microbatches=2)(
            params, training.adamw_init(params), batch)
        half = {"enc_embeds": (2, SE, cfg.d_model), "dec_tokens": (2, S), "labels": (2, S)}
        assert seen == [half, half]


# ---------------------------------------------------------------------------
# checkpoints, both ways; the loop's batches
# ---------------------------------------------------------------------------


class TestCheckpoints:
    @pytest.mark.parametrize("case", ["zamba2-rem", "seamless-m4t"])
    def test_jax_checkpoint_resumes_in_port(self, case, tmp_path):
        """JAX trains 4 steps and checkpoints at 2; the port restores step 2
        (bit-equal to the file) and trains 2 more on the same stream: its
        losses are JAX's (for enc-dec the loop's hashed one-hot frames and
        labels-as-decoder-tokens mirror the reference's)."""
        arch, kw, flags = CASES[case]
        cfg_j, cfg = cfg_pair(arch, **kw)
        dc = dict(vocab_size=cfg.vocab_size, seq_len=S, batch_size=2)
        oc = dict(lr=1e-3, warmup_steps=1, total_steps=4)
        jdir, tdir = tmp_path / "jax", tmp_path / "port"
        _, hist_j = jtrain.train_loop(jax_build_model(cfg_j, JaxFlags(remat=False, **flags)),
                                      jtrain.DataConfig(**dc), jtrain.AdamWConfig(**oc), n_steps=4,
                                      ckpt_dir=str(jdir), ckpt_every=2, log_every=1,
                                      log_fn=lambda s: None)
        tdir.mkdir()
        shutil.copy(jdir / "ckpt_00000002.npz", tdir)
        model = build_model(cfg, RuntimeFlags(**flags))
        params = model.init(seed=1, device="cpu")
        state = training.adamw_init(params)
        training.restore_checkpoint(str(tdir), (params, state))
        with np.load(jdir / "ckpt_00000002.npz") as data:
            for path, a in leaves_with_paths({"0": export_params(params)}):
                np.testing.assert_array_equal(a, data[path])
            for k in ("mu", "nu"):
                for path, a in leaves_with_paths({k: jax.tree.map(to_numpy, restack(state[k]))}):
                    np.testing.assert_array_equal(a, data["1/" + path])
        logs = []
        _, hist_t = training.train_loop(model, training.DataConfig(**dc),
                                        training.AdamWConfig(**oc), n_steps=4,
                                        ckpt_dir=str(tdir), log_every=1, log_fn=logs.append,
                                        params=model.init(seed=2, device="cpu"))
        assert logs[0] == f"restored step 2 from {tdir}"
        assert [h["step"] for h in hist_t] == [2, 3]
        for h in hist_t:
            want = hist_j[h["step"]]["loss"]
            assert abs(h["loss"] - want) <= LOSS_TOL, (h["step"], h["loss"], want)

    @pytest.mark.parametrize("case", ["zamba2-rem", "seamless-m4t"])
    def test_port_checkpoint_restores_in_jax(self, case, tmp_path):
        """The port trains 2 steps and saves; the reference's
        restore_checkpoint reads it bit for bit, and the reference's own
        save of the same tree has the same entries and bytes."""
        arch, kw, flags = CASES[case]
        cfg_j, cfg = cfg_pair(arch, **kw)
        model = build_model(cfg, RuntimeFlags(**flags))
        params, _ = training.train_loop(
            model, training.DataConfig(vocab_size=cfg.vocab_size, seq_len=8, batch_size=2),
            training.AdamWConfig(lr=1e-3, warmup_steps=1), n_steps=2, ckpt_dir=str(tmp_path),
            ckpt_every=2, log_fn=lambda s: None, params=model.init(seed=3, device="cpu"))
        pj, _ = jax_build_model(cfg_j).init(jax.random.PRNGKey(0))
        (rp, rs), step = jtrain.restore_checkpoint(str(tmp_path), (pj, jtrain.adamw_init(pj)))
        assert step == 2 and int(rs["step"]) == 2
        for (path, a), (_, b) in zip(leaves_with_paths(rp),
                                     leaves_with_paths(export_params(params))):
            assert a.dtype == b.dtype and a.shape == b.shape, path
            assert a.tobytes() == b.tobytes(), path
        jtrain.save_checkpoint(str(tmp_path / "again"), 2, (rp, rs))
        with np.load(tmp_path / "ckpt_00000002.npz") as ours, \
                np.load(tmp_path / "again" / "ckpt_00000002.npz") as theirs:
            assert ours.files == theirs.files
            for k in ours.files:
                assert ours[k].tobytes() == theirs[k].tobytes(), k


# ---------------------------------------------------------------------------
# entry points and serving
# ---------------------------------------------------------------------------

FAMILY_ARCHS = ["zamba2-7b", "xlstm-1.3b", "seamless-m4t-large-v2"]


class TestEntryPoints:
    @pytest.mark.parametrize("arch", FAMILY_ARCHS)
    def test_launch_train(self, arch, capsys):
        from repro_torch.launch import train

        train.main(["--arch", arch, "--device", "cpu", "--steps", "2", "--seq", "16",
                    "--batch", "2"])
        out = capsys.readouterr().out
        assert f"[train] {arch}" in out and "[train] done: loss" in out
        first, last = out.split("[train] done: loss ")[1].split()[0:3:2]
        assert np.isfinite(float(first)) and np.isfinite(float(last))

    @pytest.mark.parametrize("arch", FAMILY_ARCHS)
    def test_train_loop_finite_and_learning(self, arch):
        cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
        model = build_model(cfg, RuntimeFlags(remat=True))
        _, hist = training.train_loop(
            model, training.DataConfig(vocab_size=cfg.vocab_size, seq_len=16, batch_size=4),
            training.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=6), n_steps=6,
            log_every=1, log_fn=lambda s: None, params=model.init(seed=0, device="cpu"))
        assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in hist)
        assert hist[-1]["loss"] < hist[0]["loss"]


class TestServingRecordsNoGraph:
    @pytest.mark.parametrize("arch", FAMILY_ARCHS)
    def test_prefill_decode_engine(self, arch):
        """Prefill, decode and the engine stay under no_grad on parameters
        that require grad: no output or cache leaf requires grad, and
        decode's in-place state updates raise no autograd error."""
        from repro_torch.serving import GenRequest, InferenceEngine

        cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
        model = build_model(cfg)
        params = model.init(seed=0, device="cpu").requires_grad_(True)
        rng = np.random.default_rng(40)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 6)))
        if model.is_encdec:
            prompt = {"enc_embeds": torch.from_numpy(rand(41, (2, 5, cfg.d_model), 0.5)),
                      "dec_tokens": toks}
        else:
            prompt = toks
        logits, cache = model.prefill(params, prompt)
        leaves = jax.tree_util.tree_leaves(cache)
        assert not logits.requires_grad and not any(t.requires_grad for t in leaves)
        cache = model.init_cache(2, 8, device="cpu", **({"enc_len": 5} if model.is_encdec
                                                        else {}))
        logits, cache = model.decode(params, cache, toks[:, 0], torch.zeros(2, dtype=torch.int32))
        leaves = jax.tree_util.tree_leaves(cache)
        assert not logits.requires_grad and not any(t.requires_grad for t in leaves)
        if model.is_encdec:
            req = GenRequest(uid=0, prompt={"enc_embeds": prompt["enc_embeds"][0],
                                            "dec_tokens": toks[0]}, max_new_tokens=3)
            engine = InferenceEngine(model, params, max_batch=2, max_seq=16, device="cpu",
                                     enc_len=5)
        else:
            req = GenRequest(uid=0, prompt=toks[0], max_new_tokens=3)
            engine = InferenceEngine(model, params, max_batch=2, max_seq=16, device="cpu")
        out = engine.generate([req])
        assert out[0].n_tokens == 3
