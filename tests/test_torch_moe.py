"""The port's moe family against the JAX reference on the CPU.

`models/moe.py` against `repro.models.moe` on the same weights and inputs
(numpy from a seed), float32: both dispatches at the reference's own bar
for them (2e-4, tests/test_components.py), tight capacity (the same kept
picks, exactly), the aux losses, the capacity rule, and the order of tied
router scores. The reference's init scales the expert weights by 1/sqrt(E),
so at smoke size the outputs reach ~1700 and f32 rounding in two BLAS
libraries differs by ~4e-7 of that; `close_moe` holds them to 2e-4 of the
largest reference output (rtol 2e-4 besides).

Then mixtral-8x22b and llama4-scout at smoke size through
`Model.forward/prefill/decode` (seeded non-zero gammas, `TOL` as in
tests/test_consistency.py), the engine's greedy tokens, parameter
conversion, and decode into a cache smaller than mixtral's window.
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
from repro.models import moe as jax_moe  # noqa: E402
from repro.models.common import Initializer  # noqa: E402
from repro.serving import GenRequest as JaxRequest  # noqa: E402
from repro.serving import InferenceEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import convert_params  # noqa: E402
from repro_torch.models import RuntimeFlags, build_model  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.serving import GenRequest, InferenceEngine  # noqa: E402

ARCHS = ["mixtral-8x22b", "llama4-scout-17b-a16e"]  # top-2 of 4, top-1 of 4 (smoke)
MOE_TOL = 2e-4
TOL = 2e-3
RING_TOL = 5e-3
S, EXTRA, B = 12, 3, 2


def smoke(arch, **kw):
    return (dataclasses.replace(jax_get_config(arch, smoke=True), dtype="float32", **kw),
            dataclasses.replace(get_config(arch, smoke=True), dtype="float32", **kw))


def moe_pair(arch, seed=0):
    """(JAX moe params, the port's `MoE` on the same weights)."""
    cfg_j, cfg_t = smoke(arch)
    pj = jax_moe.init_moe(Initializer(jax.random.PRNGKey(seed), jnp.float32), cfg_j)
    pt = moe.MoE(cfg_t, device="cpu", dtype=torch.float32)
    pt.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in pj.items()}, strict=True)
    return pj, pt


def tokens_in(d, seq=33, seed=1):
    return np.random.default_rng(seed).standard_normal((2, seq, d)).astype(np.float32)


def close(a, b, tol, msg=""):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=tol, atol=tol, err_msg=msg)


def close_moe(a, b, msg=""):
    scale = float(np.abs(np.asarray(b)).max())
    close(a.detach().numpy() / scale, np.asarray(b) / scale, MOE_TOL, msg)


def routes(cfg_j, cfg_t, pj, pt, x):
    """(gate_idx, pos_sel, keep_k) of both sides at the capacity of x."""
    C = moe.expert_capacity(cfg_t, x.shape[1])
    rj = jax_moe._route(pj, jnp.asarray(x), cfg_j, C)
    rt = moe._route(pt, torch.from_numpy(x), cfg_t, C)
    return [(np.asarray(rj[i]), rt[i].numpy()) for i in (1, 2, 3)]


# ---------------------------------------------------------------------------
# moe_forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dispatch", ["scatter", "einsum"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_forward_matches_jax(arch, dispatch):
    cfg_j, cfg_t = smoke(arch)
    pj, pt = moe_pair(arch)
    x = tokens_in(cfg_t.d_model)
    yj, _ = jax_moe.moe_forward(pj, jnp.asarray(x), cfg_j, dispatch)
    yt, _ = moe.moe_forward(pt, torch.from_numpy(x), cfg_t, dispatch)
    assert yt.shape == x.shape
    close_moe(yt, yj)


@pytest.mark.parametrize("dispatch", ["scatter", "einsum"])
@pytest.mark.parametrize("cf", [0.25, 0.5])
@pytest.mark.parametrize("arch", ARCHS)
def test_tight_capacity_keeps_the_same_picks(arch, cf, dispatch):
    cfg_j, cfg_t = smoke(arch, capacity_factor=cf)
    pj, pt = moe_pair(arch)
    x = tokens_in(cfg_t.d_model, seq=64, seed=2)
    picks = routes(cfg_j, cfg_t, pj, pt, x)
    for (a, b), what in zip(picks, ("gate_idx", "pos_sel", "keep_k")):
        np.testing.assert_array_equal(b, a, err_msg=what)
    assert not picks[2][1].all(), "capacity this tight must drop picks"
    yj, _ = jax_moe.moe_forward(pj, jnp.asarray(x), cfg_j, dispatch)
    yt, _ = moe.moe_forward(pt, torch.from_numpy(x), cfg_t, dispatch)
    close_moe(yt, yj)


@pytest.mark.parametrize("cf", [None, 0.5])
@pytest.mark.parametrize("arch", ARCHS)
def test_aux_losses_match_jax(arch, cf):
    kw = {} if cf is None else {"capacity_factor": cf}
    cfg_j, cfg_t = smoke(arch, **kw)
    pj, pt = moe_pair(arch)
    x = tokens_in(cfg_t.d_model, seed=3)
    _, aj = jax_moe.moe_forward(pj, jnp.asarray(x), cfg_j)
    _, at = moe.moe_forward(pt, torch.from_numpy(x), cfg_t)
    assert set(at) == set(aj) == {"moe_lb_loss", "moe_z_loss"}
    for name in aj:
        np.testing.assert_allclose(float(at[name]), float(aj[name]), rtol=1e-5, err_msg=name)
    out, none = moe.moe_forward(pt, torch.from_numpy(x), cfg_t, aux=False)
    assert none == {}
    assert torch.equal(out, moe.moe_forward(pt, torch.from_numpy(x), cfg_t)[0])


@pytest.mark.parametrize("cf", [None, 0.25, 0.5, 4.0])
@pytest.mark.parametrize("smoke_size", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_expert_capacity_equals_jax(arch, smoke_size, cf):
    cfg_j, cfg_t = jax_get_config(arch, smoke=smoke_size), get_config(arch, smoke=smoke_size)
    if cf is not None:
        cfg_j = dataclasses.replace(cfg_j, capacity_factor=cf)
        cfg_t = dataclasses.replace(cfg_t, capacity_factor=cf)
    got = [moe.expert_capacity(cfg_t, s) for s in range(1, 601)]
    assert got == [jax_moe.expert_capacity(cfg_j, s) for s in range(1, 601)]
    assert moe.expert_capacity(cfg_t, 1) == 8  # a decode row's group


@pytest.mark.parametrize("router", ["pairs", "zeros"])
@pytest.mark.parametrize("arch", ARCHS)
def test_tied_router_scores_pick_the_lower_expert_first(arch, router):
    """Router columns duplicated in pairs (or all zero): every token's best
    scores tie, and both sides must pick as `jax.lax.top_k` does."""
    cfg_j, cfg_t = smoke(arch)
    pj, pt = moe_pair(arch)
    r = np.array(pj["router"])
    r = r[:, np.arange(r.shape[1]) // 2 * 2] if router == "pairs" else np.zeros_like(r)
    pj = dict(pj, router=jnp.asarray(r))
    pt.router.copy_(torch.from_numpy(r))
    x = tokens_in(cfg_t.d_model, seed=4)
    (gj, gt), _, _ = routes(cfg_j, cfg_t, pj, pt, x)
    np.testing.assert_array_equal(gt, gj)
    if router == "pairs":
        assert (gt[..., 0] % 2 == 0).all()  # the lower of the tied pair comes first
        if cfg_t.top_k == 2:
            np.testing.assert_array_equal(gt[..., 1], gt[..., 0] + 1)
    else:
        np.testing.assert_array_equal(gt, np.broadcast_to(np.arange(cfg_t.top_k), gt.shape))
    yj, _ = jax_moe.moe_forward(pj, jnp.asarray(x), cfg_j)
    yt, _ = moe.moe_forward(pt, torch.from_numpy(x), cfg_t)
    close_moe(yt, yj)


# ---------------------------------------------------------------------------
# the moe family through Model
# ---------------------------------------------------------------------------

_PAIRS = {}


def pair(arch):
    """(jax model, jax params, port model, port params, numpy params) on the
    same weights, with seeded non-zero norm gammas."""
    if arch not in _PAIRS:
        cfg_j, cfg_t = smoke(arch)
        mj = jax_build_model(cfg_j, JaxFlags(remat=False))
        pj, _ = mj.init(jax.random.PRNGKey(0))
        pn = jax.tree.map(lambda a: np.array(a, np.float32), pj)
        rng = np.random.default_rng(ARCHS.index(arch))
        for tree, name in ((pn["layers"], "attn_norm"), (pn["layers"], "mlp_norm"),
                           (pn, "final_norm")):
            tree[name] = (1.0 + 0.1 * rng.standard_normal(tree[name].shape)).astype(np.float32)
        _PAIRS[arch] = (mj, jax.tree.map(jnp.asarray, pn), build_model(cfg_t),
                        convert_params(pn, cfg_t, device="cpu"), pn)
    return _PAIRS[arch]


def token_ids(cfg, seq, seed=0, batch=B):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)


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


@pytest.mark.parametrize("arch", ARCHS)
class TestModelAgainstJax:
    def test_forward_with_aux(self, arch):
        mj, pj, mt, pt, _ = pair(arch)
        x = token_ids(mt.cfg, S)
        lj, aj = mj.forward(pj, jnp.asarray(x))
        lt, at = mt.forward(pt, torch.from_numpy(x))
        close(lt, lj, TOL)
        assert set(at) == set(aj) == {"moe_lb_loss", "moe_z_loss"}
        for name in aj:
            np.testing.assert_allclose(float(at[name]), float(aj[name]), rtol=TOL, err_msg=name)

    def test_prefill(self, arch):
        mj, pj, mt, pt, _ = pair(arch)
        x = token_ids(mt.cfg, S, seed=1)
        lj, cj = mj.prefill(pj, jnp.asarray(x))
        lt, ct = mt.prefill(pt, torch.from_numpy(x))
        close(lt, lj, TOL)
        close(ct["k"], cj["k"], TOL)
        close(ct["v"], cj["v"], TOL)
        np.testing.assert_array_equal(ct["pos"].numpy(), np.asarray(cj["pos"]))

    def test_decode_steps(self, arch):
        """Decode after prefill equals JAX's decode and the port's own
        forward (the smoke configs are dropless)."""
        mj, pj, mt, pt, _ = pair(arch)
        x = token_ids(mt.cfg, S + EXTRA, seed=2)
        full, _ = mt.forward(pt, torch.from_numpy(x))
        _, cj = mj.prefill(pj, jnp.asarray(x[:, :S]))
        _, ct = mt.prefill(pt, torch.from_numpy(x[:, :S]))
        cj, ct = pad_jax_cache(cj, EXTRA), pad_cache(ct, EXTRA)
        for i in range(EXTRA):
            pos = np.full((B,), S + i, np.int32)
            lj, cj = mj.decode(pj, cj, jnp.asarray(x[:, S + i]), jnp.asarray(pos))
            lt, ct = mt.decode(pt, ct, torch.from_numpy(x[:, S + i]), torch.from_numpy(pos))
            close(lt, lj, TOL, msg=f"decode step {i} vs JAX")
            close(lt, full[:, S + i], TOL, msg=f"decode step {i} vs forward")

    def test_einsum_dispatch_equals_scatter(self, arch):
        _, _, mt, pt, _ = pair(arch)
        x = torch.from_numpy(token_ids(mt.cfg, S, seed=3))
        a, aux_a = mt.forward(pt, x)
        b, aux_b = build_model(mt.cfg, RuntimeFlags(moe_dispatch="einsum")).forward(pt, x)
        close_moe(b, a.numpy())
        for name in aux_a:
            assert float(aux_b[name]) == pytest.approx(float(aux_a[name]), rel=1e-6)

    def test_engine_greedy_equals_jax(self, arch):
        """The engine has no moe code: its greedy tokens equal the JAX
        engine's, over a cache (24 slots) smaller than mixtral's window (64)."""
        mj, pj, mt, pt, _ = pair(arch)
        ps = [token_ids(mt.cfg, n, seed=10 + i, batch=1)[0] for i, n in enumerate([6, 8, 6])]
        reqs = [GenRequest(uid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(ps)]
        ours = InferenceEngine(mt, pt, max_batch=2, max_seq=24, device="cpu").generate(reqs)
        theirs = JaxEngine(mj, pj, max_batch=2, max_seq=24).generate(
            [JaxRequest(uid=r.uid, prompt=jnp.asarray(r.prompt), max_new_tokens=4)
             for r in reqs])
        for r in reqs:
            assert ours[r.uid].tokens == theirs[r.uid].tokens, r.uid

    def test_batched_equals_sequential(self, arch):
        _, _, mt, pt, _ = pair(arch)
        ps = [token_ids(mt.cfg, n, seed=20 + i, batch=1)[0] for i, n in enumerate([5, 9, 7])]
        reqs = [GenRequest(uid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(ps)]
        batched = InferenceEngine(mt, pt, max_batch=3, max_seq=24, device="cpu").generate(reqs)
        for r in reqs:
            solo = InferenceEngine(mt, pt, max_batch=1, max_seq=24, device="cpu").generate([r])
            assert solo[r.uid].tokens == batched[r.uid].tokens, r.uid

    def test_convert_round_trips_the_moe_leaves(self, arch):
        _, _, mt, pt, pn = pair(arch)
        state = pt.state_dict()
        leaves = pn["layers"]["moe"]
        assert set(leaves) == {"router", "w1", "w2", "w3"}
        for name, arr in leaves.items():
            for i in range(mt.cfg.n_layers):
                np.testing.assert_array_equal(state[f"layers.{i}.moe.{name}"].numpy(), arr[i])
        assert not any(".mlp." in k for k in state)
        E, d, f = mt.cfg.n_experts, mt.cfg.d_model, mt.cfg.d_ff
        assert pt.layers[0].moe.w1.shape == (E, d, f) and pt.layers[0].moe.w2.shape == (E, f, d)


class TestCacheSmallerThanWindow:
    """mixtral's own window (64 at smoke size) over a cache of 24 slots:
    exact while no position wraps, refused at the first that would."""

    SC = 24

    def test_decode_equals_jax_until_it_would_wrap(self):
        mj, pj, mt, pt, _ = pair("mixtral-8x22b")
        assert self.SC < mt.cfg.window
        toks = token_ids(mt.cfg, self.SC + 1, seed=9)
        full, _ = mt.forward(pt, torch.from_numpy(toks[:, :self.SC]))
        cj, _ = mj.init_cache(B, self.SC)
        ct = mt.init_cache(B, self.SC, device="cpu")
        for t in range(self.SC):
            pos = np.full((B,), t, np.int32)
            lj, cj = mj.decode(pj, cj, jnp.asarray(toks[:, t]), jnp.asarray(pos))
            lt, ct = mt.decode(pt, ct, torch.from_numpy(toks[:, t]), torch.from_numpy(pos))
            close(lt, lj, RING_TOL, msg=f"t={t} vs JAX")
            close(lt, full[:, t], RING_TOL, msg=f"t={t} vs forward")
        np.testing.assert_array_equal(ct["pos"].numpy(), np.asarray(cj["pos"]))
        pos = torch.full((B,), self.SC, dtype=torch.int32)
        with pytest.raises(ValueError, match="would wrap"):
            mt.decode(pt, ct, torch.from_numpy(toks[:, self.SC]), pos)

    def test_engine_finished_slot_does_not_trip_the_wrap_check(self):
        """A request that fills the cache exactly (4 + 21 - 1 = 24 slots)
        finishes while the other still decodes: the finished row is parked
        at position 0, so the next lock-step decode stays below the 24-slot
        cache and both engines serve both requests with equal tokens."""
        mj, pj, mt, pt, _ = pair("mixtral-8x22b")
        ps = [token_ids(mt.cfg, n, seed=30 + i, batch=1)[0] for i, n in enumerate([4, 2])]
        reqs = [GenRequest(uid=i, prompt=p, max_new_tokens=m)
                for i, (p, m) in enumerate(zip(ps, [21, 23]))]
        ours = InferenceEngine(mt, pt, max_batch=2, max_seq=self.SC, device="cpu").generate(reqs)
        theirs = JaxEngine(mj, pj, max_batch=2, max_seq=self.SC).generate(
            [JaxRequest(uid=r.uid, prompt=jnp.asarray(r.prompt), max_new_tokens=r.max_new_tokens)
             for r in reqs])
        for r in reqs:
            assert len(ours[r.uid].tokens) == r.max_new_tokens
            assert ours[r.uid].tokens == theirs[r.uid].tokens, r.uid
