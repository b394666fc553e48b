"""The port's training against the JAX package on the CPU: rmsnorm's
gradient (plain backward and `RMSNormFn`) against `jax.vjp`, the loss and
every gradient leaf against `jax.value_and_grad(model.loss)`, AdamW on
identical gradients, microbatching, the synthetic stream, and checkpoints
that each package restores from the other.

Weights come from the reference's `Model.init` and are carried over by
`convert_params`; inputs are made by numpy from a seed. Tolerances: kernel
level `TOLS` (tests/test_kernels.py), the loss at the model-level 2e-3
(tests/test_consistency.py), each gradient leaf at 2e-4 of its largest
magnitude, the optimizer at 1e-6.
"""

import dataclasses
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

import repro.training as jtrain  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import RuntimeFlags as JaxFlags  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models.common import rms_norm as jax_rms_norm  # noqa: E402
from repro.models.model import cross_entropy_loss as jax_cross_entropy  # noqa: E402
from repro_torch import training  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    convert_params, export_params, reference_rank, restack, to_numpy)
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import RuntimeFlags, build_model  # noqa: E402
from repro_torch.models.model import cross_entropy_loss  # noqa: E402

TOLS = {"float32": 2e-5, "bfloat16": 2e-2}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
LOSS_TOL, GRAD_TOL, OPT_TOL = 2e-3, 2e-4, 1e-6
B, S = 2, 12
TRAIN_ARCHS = ["llama2-7b", "glm4-9b", "qwen2-vl-72b", "mixtral-8x22b"]


def rand(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


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
        scale = max(float(np.abs(b).max()), 1e-30)
        err = float(np.abs(a.astype(np.float32) - b.astype(np.float32)).max())
        assert err <= tol * scale, f"{what} {path}: max|err| {err:.3g} > {tol} x {scale:.3g}"


def as_bf16(a):
    """A port export's bf16 leaf (uint16 raw bits) as ml_dtypes' bfloat16."""
    return a.view(ml_dtypes.bfloat16) if a.dtype == np.uint16 else a


# ---------------------------------------------------------------------------
# rmsnorm's gradient
# ---------------------------------------------------------------------------


class TestRMSNormBackward:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("shape", [(8, 128), (3, 37, 64), (1, 256), (15, 4096), (2, 5, 37)])
    def test_plain_and_function_against_jax_vjp(self, dtype, shape):
        x, dy = rand(0, shape), rand(1, shape)
        g = 1.0 + 0.1 * rand(2, shape[-1:])
        jdt = getattr(jnp, dtype)
        xj, gj, dyj = (jnp.asarray(a).astype(jdt) for a in (x, g, dy))
        yj, vjp = jax.vjp(lambda a, b: jax_rms_norm(a, b, 1e-5), xj, gj)
        dxj, dgj = vjp(dyj)
        xt, gt, dyt = (torch.from_numpy(a).to(TORCH[dtype]) for a in (x, g, dy))
        dx, dg = ref.rmsnorm_bwd(xt, gt, dyt, 1e-5)
        assert dx.dtype == xt.dtype and dg.dtype == gt.dtype and dx.shape == xt.shape
        xr, gr = xt.clone().requires_grad_(), gt.clone().requires_grad_()
        y = ops.rmsnorm(xr, gr, 1e-5)  # RMSNormFn on the CPU: ref forward and backward
        y.backward(dyt)
        tol = TOLS[dtype]
        f32 = lambda a: np.asarray(a.float() if isinstance(a, torch.Tensor) else a, np.float32)
        np.testing.assert_allclose(f32(y.detach()), f32(yj), rtol=tol, atol=tol)
        for got in ((dx, dg), (xr.grad, gr.grad)):
            np.testing.assert_allclose(f32(got[0]), f32(dxj), rtol=tol, atol=tol)
            if dtype == "float32":
                np.testing.assert_allclose(f32(got[1]), f32(dgj), rtol=tol, atol=tol)
            else:  # the reference sums dgamma's rows in bf16 (5% off at 111 rows):
                # held at tol of the largest |dgamma|, the gradient-leaf rule
                err = np.abs(f32(got[1]) - f32(dgj)).max()
                assert err <= tol * np.abs(f32(dgj)).max(), err

    def test_function_backward_is_the_plain_backward(self):
        x, dy = torch.from_numpy(rand(3, (6, 64))), torch.from_numpy(rand(4, (6, 64)))
        g = torch.from_numpy(1.0 + 0.1 * rand(5, (64,)))
        xr, gr = x.clone().requires_grad_(), g.clone().requires_grad_()
        ops.rmsnorm(xr, gr).backward(dy)
        dx, dg = ref.rmsnorm_bwd(x, g, dy)
        assert torch.equal(xr.grad, dx) and torch.equal(gr.grad, dg)

    def test_gradcheck_f64(self):
        gen = torch.Generator().manual_seed(0)
        x = torch.randn(5, 3, 7, dtype=torch.float64, generator=gen, requires_grad=True)
        g = (1 + 0.1 * torch.randn(7, dtype=torch.float64, generator=gen)).requires_grad_()
        assert torch.autograd.gradcheck(lambda a, b: ops.rmsnorm(a, b, 1e-5), (x, g))

    def test_strided_rows_and_expanded_gradient(self):
        """The final norm's x[:, -1] rows and a gradient of stride 0 (from a sum)."""
        base = torch.from_numpy(rand(6, (3, 5, 32))).requires_grad_()
        g = torch.ones(32, requires_grad=True)
        ops.rmsnorm(base[:, -1], g).sum().backward()
        x = base.detach()[:, -1].clone().requires_grad_()
        ref.rmsnorm(x, g.detach()).sum().backward()
        torch.testing.assert_close(base.grad[:, -1], x.grad, rtol=1e-6, atol=1e-6)
        assert float(base.grad[:, :-1].abs().max()) == 0.0


class TestRawWrappersRefuseGrad:
    """A kernel output has no grad_fn: the raw wrappers raise rather than
    let autograd drop a gradient (before any device check)."""

    def test_rmsnorm(self):
        from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_bwd

        x, g = torch.ones(2, 8, requires_grad=True), torch.ones(8)
        with pytest.raises(RuntimeError, match="requires grad"):
            rmsnorm(x, g)
        with pytest.raises(RuntimeError, match="requires grad"):
            rmsnorm_bwd(x, g, torch.ones(2, 8))
        with torch.no_grad(), pytest.raises(ValueError, match="on the card"):
            rmsnorm(x, g)  # no gradient recorded: only the device check is left

    def test_attention(self):
        from repro_torch.kernels.decode_attention import decode_attention
        from repro_torch.kernels.flash_attention import flash_attention

        q = torch.ones(1, 4, 2, 16, requires_grad=True)
        k = torch.ones(1, 4, 2, 16)
        with pytest.raises(RuntimeError, match="requires grad"):
            flash_attention(q, k, k)
        pos = torch.zeros(1, dtype=torch.int32)
        with pytest.raises(RuntimeError, match="requires grad"):
            decode_attention(q[:, 0], k, k, torch.zeros(1, 4, dtype=torch.int32), pos)

    def test_attention_rule_under_grad(self):
        rt = RuntimeFlags()
        assert rt.attn_impl_for(16, on_cuda=True) == "pallas"  # serving: the kernel
        assert rt.attn_impl_for(16, on_cuda=True, grad=True) == "naive"
        assert rt.attn_impl_for(4096, on_cuda=True, grad=True) == "chunked"
        with pytest.raises(ValueError, match="no backward"):
            RuntimeFlags(attention_impl="pallas").attn_impl_for(16, True, grad=True)


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------


class TestCrossEntropy:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_against_reference(self, dtype):
        logits = rand(7, (B, S, 96), scale=3.0)
        labels = np.random.default_rng(8).integers(0, 90, (B, S)).astype(np.int32)
        want = jax_cross_entropy(jnp.asarray(logits).astype(getattr(jnp, dtype)),
                                 jnp.asarray(labels), 90)
        got = cross_entropy_loss(torch.from_numpy(logits).to(TORCH[dtype]),
                                 torch.from_numpy(labels), 90)
        assert abs(float(got) - float(want)) <= 1e-5

    def test_gradient_rounds_the_picked_logit_through_bf16(self):
        logits = rand(9, (1, 3, 16))
        labels = np.array([[1, 5, 7]], np.int32)
        gj = jax.grad(lambda lg: jax_cross_entropy(lg, jnp.asarray(labels), 16))(
            jnp.asarray(logits))
        lt = torch.from_numpy(logits).requires_grad_()
        cross_entropy_loss(lt, torch.from_numpy(labels), 16).backward()
        np.testing.assert_allclose(lt.grad.numpy(), np.asarray(gj), rtol=1e-6, atol=1e-7)


_JAX = {}


def jax_pair(arch):
    """(port config, reference params as numpy with seeded non-zero QKV biases
    and gammas, batch, reference loss, reference grads), cached per arch."""
    if arch not in _JAX:
        cfg_j = dataclasses.replace(jax_get_config(arch, smoke=True), dtype="float32")
        mj = jax_build_model(cfg_j, JaxFlags(remat=False))
        pj, _ = mj.init(jax.random.PRNGKey(0))
        rng = np.random.default_rng(11)

        def nudge(path, a):
            leaf = str(getattr(path[-1], "key", path[-1]))
            a = np.asarray(a)
            if leaf in ("bq", "bk", "bv"):
                return (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
            if leaf.endswith("norm"):
                return (1.0 + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
            return a

        pn = jax.tree_util.tree_map_with_path(nudge, pj)
        cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
        toks = np.random.default_rng(12).integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
        batch = {"labels": toks[:, 1:]}
        if cfg.embeds_input:
            batch["embeds"] = rand(13, (B, S, cfg.d_model), scale=0.02)
        else:
            batch["tokens"] = toks[:, :-1]
        (lj, _), gj = jax.value_and_grad(mj.loss, has_aux=True)(
            jax.tree.map(jnp.asarray, pn), {k: jnp.asarray(v) for k, v in batch.items()})
        _JAX[arch] = (cfg, pn, batch, float(lj), jax.tree.map(np.asarray, gj))
    return _JAX[arch]


def port_loss_and_grads(cfg, pn, batch, **flags):
    model = build_model(cfg, RuntimeFlags(**flags))
    params = convert_params(pn, cfg, device="cpu").requires_grad_(True)
    loss, aux = model.loss(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    names, leaves = zip(*params.named_parameters())
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    return float(loss.detach()), aux, jax.tree.map(to_numpy, restack(dict(zip(names, grads))))


class TestLossAndGradients:
    @pytest.mark.parametrize("remat", [True, False])
    @pytest.mark.parametrize("arch", TRAIN_ARCHS)
    def test_against_jax_value_and_grad(self, arch, remat):
        cfg, pn, batch, lj, gj = jax_pair(arch)
        lt, aux, gt = port_loss_and_grads(cfg, pn, batch, remat=remat)
        assert abs(lt - lj) <= LOSS_TOL * max(1.0, abs(lj)), (lt, lj)
        assert set(aux) == ({"moe_lb_loss", "moe_z_loss"} if cfg.n_experts else set())
        assert_leaves_close(gt, gj, GRAD_TOL, f"{arch} grads")

    def test_chunked_attention_gradients(self):
        """Chunks of 4 over 12 positions, ragged at neither end: the same
        gradients as the reference's naive attention."""
        cfg, pn, batch, lj, gj = jax_pair("llama2-7b")
        lt, _, gt = port_loss_and_grads(cfg, pn, batch, attention_impl="chunked",
                                        q_chunk=4, kv_chunk=5)
        assert abs(lt - lj) <= LOSS_TOL
        assert_leaves_close(gt, gj, GRAD_TOL, "chunked grads")

    def test_serving_records_no_graph(self):
        """Prefill, decode and the engine stay under no_grad even on
        parameters that require grad: serving launches no backward."""
        from repro_torch.serving import GenRequest, InferenceEngine

        cfg = small()
        model = build_model(cfg)
        params = model.init(seed=0, device="cpu").requires_grad_(True)
        toks = torch.from_numpy(np.random.default_rng(40).integers(0, cfg.vocab_size, (2, 6)))
        logits, cache = model.prefill(params, toks)
        assert not logits.requires_grad and not cache["k"].requires_grad
        logits, cache = model.decode(params, model.init_cache(2, 8, device="cpu"), toks[:, 0],
                                     torch.zeros(2, dtype=torch.int32))
        assert not logits.requires_grad and not cache["k"].requires_grad
        out = InferenceEngine(model, params, max_batch=2, max_seq=16, device="cpu").generate(
            [GenRequest(uid=0, prompt=toks[0], max_new_tokens=3)])
        assert out[0].n_tokens == 3


# ---------------------------------------------------------------------------
# optimizer, step, data
# ---------------------------------------------------------------------------


class TestAdamW:
    def test_update_against_reference(self):
        """Three steps on identical gradients; the norms get zero gradients,
        so decay alone moves them: a block's norm (stacked (L, d) in the
        reference) decays, final_norm (d,) does not."""
        cfg, pn, _, _, _ = jax_pair("llama2-7b")
        oc_kw = dict(lr=1e-2, warmup_steps=1, total_steps=10, grad_clip=0.5)
        pj = jax.tree.map(jnp.asarray, pn)
        sj = jtrain.adamw_init(pj)
        pt = convert_params(pn, cfg, device="cpu")
        st = training.adamw_init(pt)
        names = [n for n, _ in pt.named_parameters()]
        for step in range(3):
            rng = np.random.default_rng(20 + step)
            gn = jax.tree_util.tree_map_with_path(
                lambda path, a: np.zeros_like(a) if str(path[-1].key).endswith("norm")
                else rng.standard_normal(a.shape).astype(np.float32), pn)
            pj, sj, mj = jtrain.adamw_update(jtrain.AdamWConfig(**oc_kw), pj,
                                              jax.tree.map(jnp.asarray, gn), sj)
            g_port = dict(convert_params(gn, cfg, device="cpu").named_parameters())
            pt, st, mt = training.adamw_update(training.AdamWConfig(**oc_kw), pt,
                                               {n: g_port[n].detach() for n in names}, st)
            for k in ("grad_norm", "lr"):
                assert abs(float(mt[k]) - float(mj[k])) <= OPT_TOL * abs(float(mj[k]))
        assert int(st["step"]) == int(sj["step"]) == 3
        assert_leaves_close(export_params(pt), jax.tree.map(np.asarray, pj), OPT_TOL, "params")
        for k in ("mu", "nu"):
            assert_leaves_close(jax.tree.map(to_numpy, restack(st[k])),
                                jax.tree.map(np.asarray, sj[k]), OPT_TOL, k)
        assert reference_rank("layers.0.attn_norm", pt.layers[0].attn_norm) == 2
        assert reference_rank("final_norm", pt.final_norm) == 1
        assert float((pt.layers[0].attn_norm - torch.from_numpy(pn["layers"]["attn_norm"][0]))
                     .abs().max()) > 1e-4  # decayed
        assert torch.equal(pt.final_norm, torch.from_numpy(pn["final_norm"]))  # exempt

    @pytest.mark.parametrize("step", [0, 1, 5, 10, 50, 100, 1000])
    def test_schedule(self, step):
        kw = dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
        want = float(jtrain.AdamWConfig(**kw).schedule(jnp.asarray(step)))
        got = float(training.AdamWConfig(**kw).schedule(torch.tensor(step, dtype=torch.int32)))
        assert abs(got - want) <= 1e-7


class TestTrainStep:
    def test_two_microbatches_equal_one(self):
        """Two halves of a batch, their f32 gradient sum halved, against the
        whole batch: the same loss, norm and clipped gradients (read from
        the first moment, (1 - b1) g after one step), to f32 rounding. The
        parameters after an Adam step are not compared: its first update is
        ~lr sign(g), which rounding flips where g is near 0."""
        cfg, pn, _, _, _ = jax_pair("llama2-7b")
        model = build_model(cfg)
        toks = np.random.default_rng(30).integers(0, cfg.vocab_size, (4, S + 1))
        batch = {"tokens": torch.from_numpy(toks[:, :-1]), "labels": torch.from_numpy(toks[:, 1:])}
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


class TestData:
    @pytest.mark.parametrize("seed,noise", [(0, 0.05), (3, 0.2)])
    def test_batches_equal_reference(self, seed, noise):
        kw = dict(vocab_size=97, seq_len=16, batch_size=3, seed=seed, noise=noise)
        a, b = jtrain.SyntheticLM(jtrain.DataConfig(**kw)), training.SyntheticLM(
            training.DataConfig(**kw))
        assert training.DataConfig(**kw).loss_floor == jtrain.DataConfig(**kw).loss_floor
        for step in (0, 1, 7):
            x, y = a.batch(step), b.batch(step)
            assert x.keys() == y.keys()
            for k in x:
                np.testing.assert_array_equal(x[k], y[k])


# ---------------------------------------------------------------------------
# checkpoints, both ways
# ---------------------------------------------------------------------------


def small(dtype="float32"):
    return dataclasses.replace(get_config("llama2-7b", smoke=True), dtype=dtype)


class TestCheckpoints:
    def test_jax_checkpoint_resumes_in_port(self, tmp_path):
        """JAX trains 8 steps and checkpoints at 4; the port restores step 4
        (bit-equal to the file) and trains 4 more: its losses are JAX's."""
        cfg = small()
        cfg_j = dataclasses.replace(jax_get_config("llama2-7b", smoke=True), dtype="float32")
        dc = dict(vocab_size=cfg.vocab_size, seq_len=16, batch_size=4)
        oc = dict(lr=1e-3, warmup_steps=2, total_steps=8)
        jdir, tdir = tmp_path / "jax", tmp_path / "port"
        _, hist_j = jtrain.train_loop(jax_build_model(cfg_j, JaxFlags(remat=False)),
                                      jtrain.DataConfig(**dc), jtrain.AdamWConfig(**oc), n_steps=8,
                                      ckpt_dir=str(jdir), ckpt_every=4, log_every=1,
                                      log_fn=lambda s: None)
        tdir.mkdir()
        shutil.copy(jdir / "ckpt_00000004.npz", tdir)

        model = build_model(cfg)
        params = model.init(seed=1, device="cpu")
        state = training.adamw_init(params)
        training.restore_checkpoint(str(tdir), (params, state))
        with np.load(jdir / "ckpt_00000004.npz") as data:
            for path, a in leaves_with_paths({"0": export_params(params)}):
                np.testing.assert_array_equal(a, data[path])
            for k in ("mu", "nu"):
                for path, a in leaves_with_paths({k: jax.tree.map(to_numpy, restack(state[k]))}):
                    np.testing.assert_array_equal(a, data["1/" + path])
            assert int(state["step"]) == int(data["1/step"]) == 4

        logs = []
        _, hist_t = training.train_loop(model, training.DataConfig(**dc),
                                        training.AdamWConfig(**oc), n_steps=8,
                                        ckpt_dir=str(tdir), log_every=1, log_fn=logs.append,
                                        params=model.init(seed=2, device="cpu"))
        assert logs[0] == f"restored step 4 from {tdir}"
        assert [h["step"] for h in hist_t] == [4, 5, 6, 7]
        for h in hist_t:
            want = hist_j[h["step"]]["loss"]
            assert abs(h["loss"] - want) <= LOSS_TOL, (h["step"], h["loss"], want)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_port_checkpoint_restores_in_jax(self, tmp_path, dtype):
        """The port trains 2 steps and saves; the reference's
        restore_checkpoint reads it bit for bit (bf16 through its byte
        view), and the reference's own save of the same tree has the same
        entries in the same order."""
        cfg = small(dtype)
        model = build_model(cfg)
        params, _ = training.train_loop(
            model, training.DataConfig(vocab_size=cfg.vocab_size, seq_len=8, batch_size=2),
            training.AdamWConfig(lr=1e-3, warmup_steps=1), n_steps=2, ckpt_dir=str(tmp_path),
            ckpt_every=2, log_fn=lambda s: None, params=model.init(seed=3, device="cpu"))
        mj = jax_build_model(dataclasses.replace(jax_get_config("llama2-7b", smoke=True),
                                                 dtype=dtype))
        pj, _ = mj.init(jax.random.PRNGKey(0))
        (rp, rs), step = jtrain.restore_checkpoint(str(tmp_path), (pj, jtrain.adamw_init(pj)))
        assert step == 2 and int(rs["step"]) == 2
        want = export_params(params)
        for (path, a), (_, b) in zip(leaves_with_paths(rp), leaves_with_paths(want)):
            b = as_bf16(b)
            assert a.dtype == b.dtype and a.shape == b.shape, path
            assert a.tobytes() == b.tobytes(), path
        jtrain.save_checkpoint(str(tmp_path / "again"), 2, (rp, rs))
        with np.load(tmp_path / "ckpt_00000002.npz") as ours, \
                np.load(tmp_path / "again" / "ckpt_00000002.npz") as theirs:
            assert ours.files == theirs.files
            for k in ours.files:
                assert ours[k].dtype == theirs[k].dtype and ours[k].tobytes() == theirs[k].tobytes(), k
