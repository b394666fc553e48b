"""The port's serving stack on the CPU: engine against the JAX engine
(greedy tokens equal on the same weights and prompts), batching, slot reuse,
ICC scheduling and calibration — mirroring tests/test_serving.py."""

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
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import convert_params  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    GenRequest,
    ICCRequest,
    ICCServer,
    InferenceEngine,
    SamplingParams,
    measure_service_time,
    measured_service_fn,
)

ARCH = "llama2-7b"
_CACHE = {}


def model_params():
    if not _CACHE:
        cfg_j = dataclasses.replace(jax_get_config(ARCH, smoke=True), dtype="float32")
        mj = jax_build_model(cfg_j, JaxFlags(remat=False))
        pj, _ = mj.init(jax.random.PRNGKey(0))
        cfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype="float32")
        m = build_model(cfg)
        p = convert_params(jax.tree.map(np.asarray, pj), cfg, device="cpu")
        _CACHE.update(mj=mj, pj=pj, m=m, p=p)
    return _CACHE["m"], _CACHE["p"]


def prompt(uid, n=10):
    vocab = get_config(ARCH, smoke=True).vocab_size
    return np.random.default_rng(uid).integers(0, vocab, (n,), np.int32)


def mk_req(uid, n=10, new=5, **kw):
    return GenRequest(uid=uid, prompt=prompt(uid, n), max_new_tokens=new, **kw)


def engine(max_batch, max_seq=48):
    m, p = model_params()
    return InferenceEngine(m, p, max_batch=max_batch, max_seq=max_seq, device="cpu")


class TestEngine:
    def test_greedy_tokens_equal_jax_engine(self):
        model_params()
        reqs = [mk_req(i, n=6 + 2 * i, new=6) for i in range(4)]
        ours = engine(max_batch=3).generate(reqs)
        jeng = JaxEngine(_CACHE["mj"], _CACHE["pj"], max_batch=3, max_seq=48)
        theirs = jeng.generate([
            JaxRequest(uid=r.uid, prompt=jnp.asarray(r.prompt), max_new_tokens=6)
            for r in reqs
        ])
        for r in reqs:
            assert ours[r.uid].tokens == theirs[r.uid].tokens, r.uid

    def test_batched_equals_sequential(self):
        reqs = [mk_req(i, n=8 + i, new=4) for i in range(5)]
        batched = engine(max_batch=3).generate(reqs)
        for r in reqs:
            solo = engine(max_batch=1).generate([r])
            assert solo[r.uid].tokens == batched[r.uid].tokens, r.uid

    def test_slot_reuse(self):
        out = engine(max_batch=2).generate([mk_req(i, new=3) for i in range(6)])
        assert len(out) == 6
        assert all(len(r.tokens) == 3 for r in out.values())

    def test_reset_clears_state(self):
        eng = engine(max_batch=2)
        eng.generate([mk_req(0)])
        eng.reset()
        assert eng.n_active == 0 and not eng.results
        assert int(eng._cache["pos"].max()) == -1
        out = eng.generate([mk_req(1, new=2)])
        assert len(out[1].tokens) == 2

    def test_slot_bookkeeping(self):
        eng = engine(max_batch=2)
        eng.submit(mk_req(7, new=4))
        assert eng.free_slots() == [1] and eng.active_uids() == [7] and eng.n_active == 1
        while eng.n_active:
            eng.step()
        assert eng.results[7].n_tokens == 4 and eng.results[7].decode_s > 0

    def test_request_beyond_capacity_raises(self):
        with pytest.raises(ValueError, match="max_seq"):
            engine(max_batch=1, max_seq=12).submit(mk_req(0, n=10, new=4))


class TestICCServer:
    def _trace(self, n, b_total, t_comm=0.01):
        return [
            ICCRequest(mk_req(i, new=3), t_gen=0.01 * i, t_comm=t_comm,
                       b_total=b_total, route="ran:cell0" if i % 2 == 0 else "mec")
            for i in range(n)
        ]

    def test_all_satisfied_when_budget_ample(self):
        eng = engine(max_batch=4)
        eng.warmup(prompt(0))
        stats = ICCServer(eng, policy="priority").run(self._trace(6, 60.0))
        assert stats.n_satisfied == 6 and stats.n_dropped == 0
        assert stats.route_total == {"ran:cell0": 3, "mec": 3}
        assert stats.route_satisfaction("ran:cell0") == 1.0
        assert stats.route_satisfaction("mec") == 1.0
        assert stats.route_satisfaction("unknown") == 0.0

    def test_infeasible_dropped_not_served(self):
        eng = engine(max_batch=2)
        eng.warmup(prompt(0))
        stats = ICCServer(eng, policy="priority", est_latency=10.0).run(
            self._trace(4, b_total=0.001))
        assert stats.n_dropped == 4 and not eng.results

    def test_priority_orders_by_slack(self):
        a = ICCRequest(mk_req(0), t_gen=0.0, t_comm=0.05, b_total=0.08)
        b = ICCRequest(mk_req(1), t_gen=0.0, t_comm=0.01, b_total=0.08)
        assert a.priority < b.priority  # less slack -> served first

    @pytest.mark.parametrize("policy,first", [("priority", 1), ("fifo", 0)])
    def test_admission_order(self, policy, first):
        """One slot: priority admits the least-slack request first, fifo the
        earliest arrival."""
        eng = engine(max_batch=1)
        reqs = [ICCRequest(mk_req(0, new=2), t_gen=0.0, t_comm=0.001, b_total=50.0),
                ICCRequest(mk_req(1, new=2), t_gen=0.0, t_comm=0.002, b_total=1.0)]
        srv = ICCServer(eng, policy=policy)
        for r in reqs:
            srv.offer(r)
        srv._admit()
        assert eng.active_uids() == [first]


class TestSampling:
    def test_greedy_default_unchanged(self):
        r = mk_req(42, new=4)
        assert engine(1).generate([r])[42].tokens == engine(1).generate([r])[42].tokens

    def test_stochastic_batched_equals_sequential(self):
        sp = SamplingParams(temperature=1.0, top_k=20, seed=7)
        reqs = [mk_req(i, n=8, new=4, sampling=sp) for i in range(3)]
        batched = engine(max_batch=3).generate(reqs)
        for r in reqs:
            assert engine(1).generate([r])[r.uid].tokens == batched[r.uid].tokens

    def test_temperature_diversifies(self):
        outs = set()
        for seed in range(4):
            r = GenRequest(uid=100 + seed, prompt=prompt(0, 8), max_new_tokens=6,
                           sampling=SamplingParams(temperature=2.0, seed=seed))
            outs.add(tuple(engine(1).generate([r])[r.uid].tokens))
        assert len(outs) > 1

    def test_negative_uid_samples(self):
        r = GenRequest(uid=-987654, prompt=prompt(0), max_new_tokens=3,
                       sampling=SamplingParams(temperature=1.0, seed=1))
        assert len(engine(1).generate([r])[r.uid].tokens) == 3


class TestCalibrate:
    def test_measure_service_time_positive(self):
        m, p = model_params()
        t = measure_service_time(m, p, n_input=6, n_output=3, max_seq=16, repeats=2)
        assert t["prefill_s"] > 0 and t["decode_s"] > 0
        assert t["total_s"] >= t["prefill_s"]

    def test_measured_service_fn_duck_typed_job(self):
        m, p = model_params()
        fn, t = measured_service_fn(m, p, 6, 3, max_seq=16, repeats=1)
        job = types.SimpleNamespace(n_input=6, n_output=3)
        assert fn(job) == pytest.approx(t["prefill_s"] + t["decode_s"])
