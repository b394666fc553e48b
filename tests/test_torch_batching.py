"""The port's continuous-batching node (`repro_torch.batching`) against the
reference's `repro.batching` on fixed inputs: the counterparts of
tests/test_batching.py. The copies are plain numpy with the same heap
tie-breaks, so the bar is equality: the same completions, drops and
`BatchStats`, and `simulate(node_factory=...)` `SimResult`s field by field.
"""

import copy
import dataclasses
import math

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.batching import BatchedComputeNode as RefNode  # noqa: E402
from repro.batching import KVCache as RefKVCache  # noqa: E402
from repro.core import latency_model as ref_lm  # noqa: E402
from repro.core import simulator as ref_sim  # noqa: E402
from repro.core.scheduler import Job as RefJob  # noqa: E402
from repro_torch.batching import BatchedComputeNode, BatchStats, KVCache  # noqa: E402
from repro_torch.core import simulator  # noqa: E402
from repro_torch.core.latency_model import A100, L4, LLAMA2_7B, HardwareSpec  # noqa: E402
from repro_torch.core.scheduler import ComputeNode, ComputeNodeProtocol, Job  # noqa: E402
from repro_torch.faults import Brownout, FaultSpec  # noqa: E402
from test_torch_core import assert_same  # noqa: E402
from test_torch_faults import to_ref  # noqa: E402

ICC = simulator.SchemeConfig("icc", 0.005, True, "priority", "joint")
REF_ICC = ref_sim.SchemeConfig("icc", 0.005, True, "priority", "joint")
# a small pool: 1 GB of HBM, 0.5 GB of weights, so a handful of jobs fit
EDGE = dict(name="edge-sim", flops=50e12, hbm_bw=200e9, hbm_bytes=1e9)
SMALL = dict(name="m", n_params=0.25e9, n_active_params=0.25e9, bytes_per_param=2.0,
             kv_bytes_per_token=0.5e6, state_bytes=1e6)


def mk_job(uid, t_gen=0.0, t_arr=None, n_in=16, n_out=8, b_total=100.0, cls=Job):
    j = cls(uid=uid, ue=0, t_gen=t_gen, n_input=n_in, n_output=n_out, b_total=b_total)
    j.t_compute_arrival = t_gen + 0.005 if t_arr is None else t_arr
    return j


def poisson_stream(seed, n=120, lam=20.0, b_total=2.0, n_in=(8, 64), n_out=(4, 48)):
    """(port jobs, reference jobs): the same Poisson stream in each package;
    a (low, high) `b_total` draws each job's budget uniformly."""
    rng = np.random.default_rng(seed)
    t, rows = 0.0, []
    for i in range(n):
        t += rng.exponential(1.0 / lam)
        b = float(rng.uniform(*b_total)) if isinstance(b_total, tuple) else b_total
        rows.append((i, t, int(rng.integers(*n_in)), int(rng.integers(*n_out)), b))
    return tuple([mk_job(i, t_gen=t, n_in=a, n_out=o, b_total=b, cls=cls)
                   for i, t, a, o, b in rows] for cls in (Job, RefJob))


def lm_pair(hw="a100", model="llama2", fidelity="extended"):
    """(port LatencyModel, reference LatencyModel) of the same spec."""
    def build(mod):
        h = {"a100": mod.A100, "l4": mod.L4, "edge": mod.HardwareSpec(**EDGE)}[hw]
        m = {"llama2": mod.LLAMA2_7B, "small": mod.ModelProfile(**SMALL)}[model]
        return mod.LatencyModel(h, m, fidelity=fidelity)
    from repro_torch.core import latency_model
    return build(latency_model), build(ref_lm)


def drive(node, jobs, step=0.01, n_steps=1500):
    """Submit every job, step the node like the slot simulator, drain."""
    for j in jobs:
        node.submit(j)
    for s in range(1, n_steps):
        node.run_until(s * step)
    node.run_until(math.inf)
    return node


def outcome(node):
    done = [(j.uid, j.t_complete, j.t_first_token) for j in node.completed]
    return done, [j.uid for j in node.dropped], dataclasses.asdict(node.stats)


# ------------------------------------------------------------------ KV cache
class TestKVCache:
    def test_reservation_accounting_equals_reference(self):
        kv, ref = KVCache(A100, LLAMA2_7B), RefKVCache(ref_lm.A100, ref_lm.LLAMA2_7B)
        job, rjob = mk_job(0, n_in=100, n_out=28), mk_job(0, n_in=100, n_out=28, cls=RefJob)
        assert kv.job_bytes(job) == ref.job_bytes(rjob) == \
            pytest.approx(128 * LLAMA2_7B.kv_bytes_per_token)
        assert kv.capacity_bytes == ref.capacity_bytes == A100.hbm_bytes - LLAMA2_7B.model_bytes
        kv.admit(job)
        assert kv.used_bytes == kv.job_bytes(job) and kv.utilization() > 0
        kv.release(job)
        assert kv.used_bytes == 0.0 and kv.peak_bytes == kv.job_bytes(job)

    @pytest.mark.parametrize("hw", ["A100", "L4", "H100", "GH200_NVL2"])
    def test_jobs_capacity_equals_reference(self, hw):
        from repro_torch.core import latency_model

        for n_in, n_out in ((2048, 32), (15, 15), (320, 24)):
            ours = KVCache(getattr(latency_model, hw), LLAMA2_7B).jobs_capacity(
                mk_job(0, n_in=n_in, n_out=n_out))
            assert ours == RefKVCache(getattr(ref_lm, hw), ref_lm.LLAMA2_7B).jobs_capacity(
                mk_job(0, n_in=n_in, n_out=n_out, cls=RefJob))
        # BENCH_batching.json's cache_job_cap: 9 rag_doc_qa jobs on an L4
        assert KVCache(L4, LLAMA2_7B).jobs_capacity(mk_job(0, n_in=2048, n_out=32)) == 9

    def test_weights_must_fit(self):
        tiny = HardwareSpec("tiny", flops=1e12, hbm_bw=1e11, hbm_bytes=1e9)
        with pytest.raises(ValueError, match="do not fit"):
            KVCache(tiny, LLAMA2_7B)

    def test_overflow_raises(self):
        kv = KVCache(L4, LLAMA2_7B)
        kv.admit(mk_job(0, n_in=10_000, n_out=0))
        with pytest.raises(RuntimeError, match="overflow"):
            kv.admit(mk_job(1, n_in=10_000, n_out=0))


# ------------------------------------------------------------- node protocol
class TestNodeProtocol:
    def test_both_nodes_satisfy_protocol(self):
        assert isinstance(ComputeNode(lambda j: 0.01), ComputeNodeProtocol)
        assert isinstance(BatchedComputeNode(lm_pair()[0]), ComputeNodeProtocol)

    def test_len_and_pending(self):
        node = BatchedComputeNode(lm_pair()[0], max_batch=2)
        for i in range(4):
            node.submit(mk_job(i))
        assert len(node) == 4 and sorted(j.uid for j in node.pending_jobs()) == [0, 1, 2, 3]
        node.run_until(0.01)  # the first iteration admits up to max_batch
        assert len(node.pending_jobs()) == 2 and len(node) == 4
        node.run_until(math.inf)
        assert len(node) == 0 and len(node.completed) == 4

    def test_estimated_free_at_equals_reference(self):
        (ours, ref), (jobs, rjobs) = lm_pair(), poisson_stream(seed=4, n=30)
        a, b = BatchedComputeNode(ours, max_batch=2), RefNode(ref, max_batch=2)
        assert a.estimated_free_at(0.0) == 0.0
        for j, rj in zip(jobs, rjobs):
            a.submit(j)
            b.submit(rj)
            assert a.estimated_free_at(j.t_compute_arrival) == \
                b.estimated_free_at(rj.t_compute_arrival)
            a.run_until(j.t_compute_arrival)
            b.run_until(rj.t_compute_arrival)
        a.run_until(math.inf)
        assert a.estimated_free_at(a.busy_until) == pytest.approx(a.busy_until)

    def test_invalid_arguments(self):
        with pytest.raises(ValueError, match="max_batch"):
            BatchedComputeNode(lm_pair()[0], max_batch=0)
        with pytest.raises(ValueError, match="prefill_chunk"):
            BatchedComputeNode(lm_pair()[0], prefill_chunk=0)


# --------------------------------------------------- the node against the reference
class TestNodeEqualsReference:
    @pytest.mark.parametrize("drop", [False, True])
    @pytest.mark.parametrize("policy", ["fifo", "priority"])
    @pytest.mark.parametrize("max_batch,chunked", [(1, False), (4, True), (16, True),
                                                   (8, False)])
    def test_completions_drops_and_stats(self, max_batch, chunked, policy, drop):
        """A Poisson stream with budgets of 0.2-0.8 s, tight enough that
        the least-slack order, drops at admission and preemptions occur."""
        (ours, ref), (jobs, rjobs) = lm_pair(), poisson_stream(
            seed=7, lam=40.0, b_total=(0.2, 0.8), n_in=(8, 600))
        kw = dict(max_batch=max_batch, policy=policy, drop_infeasible=drop,
                  chunked_prefill=chunked, prefill_chunk=128)
        a = drive(BatchedComputeNode(ours, **kw), jobs)
        b = drive(RefNode(ref, **kw), rjobs)
        assert outcome(a) == outcome(b)
        assert len(a.completed) + len(a.dropped) == len(jobs)
        assert type(a.stats) is BatchStats and a.stats.n_iterations > 0
        assert a.kv.used_bytes == 0.0

    @pytest.mark.parametrize("max_batch", [1, 3, 32])
    def test_kv_bound_small_pool(self, max_batch):
        """A pool a few jobs fill: KV admission binds before max_batch,
        equal to the reference, and never past the HBM."""
        (ours, ref) = lm_pair("edge", "small")
        (jobs, rjobs) = poisson_stream(seed=1, n=60, lam=50.0, b_total=100.0, n_in=(16, 600),
                                       n_out=(4, 64))
        a, b = BatchedComputeNode(ours, max_batch=max_batch), RefNode(ref, max_batch=max_batch)
        for j, rj in zip(jobs, rjobs):  # interleaved to stress admission
            a.submit(j)
            b.submit(rj)
            a.run_until(j.t_gen)
            b.run_until(rj.t_gen)
        a.run_until(math.inf)
        b.run_until(math.inf)
        assert outcome(a) == outcome(b)
        assert a.stats.peak_kv_bytes <= a.kv.capacity_bytes
        assert a.stats.peak_kv_bytes + ours.model.model_bytes <= ours.hw.hbm_bytes
        assert len(a.completed) + len(a.dropped) == 60 and a.kv.used_bytes == 0.0

    def test_cache_binds_before_max_batch(self):
        node = BatchedComputeNode(lm_pair("edge", "small")[0], max_batch=32)
        cap = node.kv.jobs_capacity(mk_job(0, n_in=100, n_out=28))
        assert cap < 32
        for i in range(40):
            node.submit(mk_job(i, n_in=100, n_out=28))
        node.run_until(math.inf)
        assert node.stats.peak_batch == cap and node.stats.kv_blocked_iterations > 0

    def test_unservable_job_dropped_not_stuck(self):
        node = BatchedComputeNode(lm_pair("edge", "small")[0], max_batch=4)
        node.submit(mk_job(0, n_in=2000, n_out=8))  # > 1 GB of KV alone
        node.submit(mk_job(1, n_in=32, n_out=8))
        node.run_until(math.inf)
        assert [j.uid for j in node.dropped] == [0] and [j.uid for j in node.completed] == [1]


@pytest.mark.parametrize("fidelity", ["paper", "extended"])
@pytest.mark.parametrize("policy", ["fifo", "priority"])
@pytest.mark.parametrize("drop", [False, True])
def test_max_batch_one_equals_compute_node(fidelity, policy, drop):
    """max_batch=1 with whole-prompt prefill is the classic whole-job node:
    the same completions and drops."""
    lm = lm_pair(fidelity=fidelity)[0]
    jobs = poisson_stream(seed=7)[0]
    classic = drive(ComputeNode(lambda j: lm.job_latency(j.n_input, j.n_output),
                                policy=policy, drop_infeasible=drop), copy.deepcopy(jobs))
    batched = drive(BatchedComputeNode(lm, max_batch=1, policy=policy, drop_infeasible=drop,
                                       chunked_prefill=False), copy.deepcopy(jobs))
    assert [j.uid for j in classic.completed] == [j.uid for j in batched.completed]
    for a, b in zip(classic.completed, batched.completed):
        assert b.t_complete == pytest.approx(a.t_complete, rel=1e-9)
    assert [j.uid for j in classic.dropped] == [j.uid for j in batched.dropped]


class TestBatchingBehaviour:
    def backlog(self, mb, n=16, **kw):
        node = BatchedComputeNode(lm_pair()[0], max_batch=mb, **kw)
        for i in range(n):
            node.submit(mk_job(i, n_in=512, n_out=32, t_arr=0.0))
        node.run_until(math.inf)
        return node

    def test_batching_raises_throughput(self):
        assert self.backlog(8).busy_until < 0.5 * self.backlog(1).busy_until

    def test_ttft_before_completion(self):
        for j in self.backlog(4).completed:
            assert j.t_compute_arrival <= j.t_first_token < j.t_complete

    def test_deadline_preemption_at_token_granularity(self):
        lm = lm_pair()[0]
        solo = lm.job_latency(512, 32)
        node = BatchedComputeNode(lm, max_batch=16, drop_infeasible=True)
        for i in range(16):
            node.submit(mk_job(i, n_in=512, n_out=32, t_arr=0.0, b_total=1.35 * solo))
        node.run_until(math.inf)
        assert node.stats.preempted > 0 and node.kv.used_bytes == 0.0
        assert len(node.completed) + len(node.dropped) == 16

    def test_chunked_prefill_interleaves_decode(self):
        node = BatchedComputeNode(lm_pair()[0], max_batch=4, prefill_chunk=128)
        node.submit(mk_job(0, n_in=512, n_out=64, t_arr=0.0))
        node.run_until(1e-6)
        node.submit(mk_job(1, n_in=512, n_out=4, t_arr=0.0))
        node.run_until(math.inf)
        j0, j1 = sorted(node.completed, key=lambda j: j.uid)
        assert j1.t_first_token < j0.t_complete

    def test_zero_output_job_is_prefill_only(self):
        lm = lm_pair()[0]
        node = BatchedComputeNode(lm, max_batch=1, chunked_prefill=False)
        j = mk_job(0, n_in=512, n_out=0, t_arr=0.0)
        node.submit(j)
        node.run_until(math.inf)
        assert node.completed == [j] and math.isnan(j.t_first_token)
        assert j.t_complete == pytest.approx(lm.job_latency(512, 0))
        assert node.stats.decode_token_iterations == 0


# ---------------------------------------------------- simulate(node_factory=)
SIM = dict(n_ues=12, sim_time=3.0, warmup=0.5, b_total=0.5, n_input=256, n_output=16, seed=5)


def simulate_both(max_batch=8, fast=True, faults=None, sim=SIM, hw="a100"):
    """(port SimResult, reference SimResult, port node, reference node) of
    the single-cell simulator on a BatchedComputeNode."""
    (ours, ref), nodes = lm_pair(hw), []

    def factory(cls, lm):
        def make():
            nodes.append(cls(lm, max_batch=max_batch, policy="priority", drop_infeasible=True))
            return nodes[-1]
        return make

    a = simulator.simulate(ICC, simulator.SimConfig(**sim), node_factory=factory(
        BatchedComputeNode, ours), fast=fast, faults=faults)
    b = ref_sim.simulate(REF_ICC, ref_sim.SimConfig(**sim), node_factory=factory(RefNode, ref),
                         fast=fast, faults=None if faults is None else to_ref(faults))
    return a, b, nodes[0], nodes[1]


class TestSimulate:
    @pytest.mark.parametrize("fast", [True, False])
    @pytest.mark.parametrize("max_batch", [1, 8])
    def test_equals_reference(self, max_batch, fast):
        a, b, na, nb = simulate_both(max_batch, fast)
        assert_same(a, b)
        assert dataclasses.asdict(na.stats) == dataclasses.asdict(nb.stats)
        assert a.n_jobs > 0 and a.avg_ttft is not None and a.avg_tbt is not None
        assert a.avg_ttft <= a.avg_e2e and a.p95_e2e <= a.p99_e2e

    def test_drops_under_overload_equal_reference(self):
        a, b, na, nb = simulate_both(4, sim=dict(SIM, n_ues=60, b_total=0.15))
        assert_same(a, b)
        assert dataclasses.asdict(na.stats) == dataclasses.asdict(nb.stats)
        assert a.drop_rate > 0

    @pytest.mark.parametrize("fast", [True, False])
    def test_brownout_equals_reference(self, fast):
        """The batched single-cell brownout of tests/test_faults.py: the
        node runs its iterations 2x slower for 1.5 s."""
        spec = FaultSpec(brownouts=(Brownout("node", 1.0, 2.5, 2.0),))
        a, b, _, _ = simulate_both(8, fast, faults=spec, sim=dict(SIM, n_ues=30))
        assert_same(a, b)
        plain = simulate_both(8, fast, sim=dict(SIM, n_ues=30))[0]
        assert a.avg_e2e > plain.avg_e2e

    def test_empty_spec_is_free(self):
        a = simulate_both(8, faults=FaultSpec())[0]
        assert_same(a, simulate_both(8)[0])

    def test_requires_exactly_one_engine(self):
        with pytest.raises(ValueError, match="exactly one"):
            simulator.simulate(ICC, simulator.SimConfig(**SIM))
        with pytest.raises(ValueError, match="exactly one"):
            simulator.simulate(ICC, simulator.SimConfig(**SIM), lambda j: 0.01,
                               node_factory=lambda: ComputeNode(lambda j: 0.01))
