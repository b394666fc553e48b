"""The dry run on a mesh (`repro_torch.launch.{cost_analysis,dryrun}`) on the
CPU: DTensor programs and smoke steps run on meta tensors over a `fake`
process group (nothing moves), on a mesh of the card's device type, as the
dry run runs them on the production meshes.

  * the counter's collective classes on small DTensor programs on a (2, 2)
    mesh, each class's bytes equal to the hand-computed weighted bytes of
    the reference's convention (`repro/launch/hlo_analysis.py`); the
    FakeTensor ops of DTensor's sharding propagation count nothing;
  * on a (1, 1) mesh, a smoke step counts the one-device FLOPs and peak
    and no collective;
  * on a (2, 2) mesh, per-device dot FLOPs x 4 equal the one-device count
    (FLOP_TOL) where every dot is sharded, and the dots that stay
    replicated over "model" are named for the other families;
  * every collective the step runs is counted: the counter's ops equal
    those `CommDebugMode` sees in the same step;
  * `sharding.redistribute`'s direct path (NCCL, fake) and its gloo detour
    give the same placements and shapes for every redistribution on a
    (2, 2) mesh;
  * llama2-7b's per-device dot FLOPs equal the reference's `analyze_hlo`
    of the same smoke step jitted on a (2, 2) mesh of 4 host devices (one
    subprocess for every kind), and the collective totals agree within the
    factor the classes account for (`-s` prints both sides by class);
  * llama2-7b's decode on (2, 2) moves, class by class, the hand-counted
    bytes: the weights' gathers, q's and the fresh K/V's head gathers and
    the merge's all-reduces, and none of its cache;
  * llama2-7b's context-parallel prefill (TRAIN_RULES_EP_CP with
    `attn_seq_shard`): each rank's block of query rows through the core
    and the block's products, the core's dot FLOPs equal to the
    reference's share, no product above the reference's (its dots read by
    their einsum), the total a four-way cut of one device's, and its
    collectives by class the hand count's; its train step no more than
    the reference's (`-s` prints both sides by site and class);
  * `--rules` names the reference's nine overrides and maps them to equal
    tables; each override and both `--moe-dispatch` values run a smoke
    case; `attn_seq_shard` shards the attention output's query-seq dim.
"""

import ast
import collections
import contextlib
import dataclasses
import itertools
import json
import math
import os
import subprocess
import sys
import traceback
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from torch.distributed.device_mesh import init_device_mesh  # noqa: E402
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard  # noqa: E402

from repro import sharding as ref_sh  # noqa: E402
from repro_torch import sharding as sh  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import cost_analysis, dryrun  # noqa: E402
from repro_torch.launch.cost_analysis import COLLECTIVES, analyze_case, analyze_step  # noqa: E402
from repro_torch.launch.mesh import fake_process_group  # noqa: E402
from repro_torch.launch.specs import ShapeSpec, build_case  # noqa: E402
from repro_torch.models import attention  # noqa: E402

FLOP_TOL = 1e-3  # tests/test_torch_launch.py's bar against analyze_hlo
PEAK_TOL = 1e-3  # a (1, 1) mesh's peak against the one-device count
META = torch.device("meta")
SRC = Path(__file__).resolve().parent.parent / "src"
F32 = 4  # bytes


@contextlib.contextmanager
def fake_mesh(shape):
    """A ("data", "model") mesh of the card's device type over a fake process
    group: this process is rank 0, collectives return at once."""
    with fake_process_group(math.prod(shape)):
        yield init_device_mesh("cuda", shape, mesh_dim_names=("data", "model"))


def dtensor(local_shape, placements, mesh):
    return DTensor.from_local(torch.empty(local_shape, device=META), mesh, placements,
                              run_check=False)


def smoke_case(arch, kind, seq=16, batch=4, **kw):
    smoke = get_config(arch, smoke=True)
    fields = {f.name: getattr(smoke, f.name) for f in dataclasses.fields(smoke)}
    return build_case(arch, ShapeSpec(f"{kind}_{seq}", kind, seq, batch), cfg_kwargs=fields, **kw)


def mesh_cost(case, shape, memo=True):
    with fake_mesh(shape) as mesh, sh.use_mesh(mesh, case.rules):
        return analyze_case(case, memo=memo, args=dryrun._on_mesh(case))


# ------------------------------------------------------------ the classes
R, P, S0, S1 = Replicate(), Partial(), Shard(0), Shard(1)
# (name, program on a (2, 2) mesh, {class: hand-computed bytes}, dot FLOPs):
# global (8, 16) f32 tensors (512 B) split over "data" (2 ranks)
PROGRAMS = [
    # a partial sum made whole: an all-reduce moves twice the tensor
    ("partial to replicate", lambda m: sh.redistribute(dtensor((8, 16), [P, R], m), [R, R]),
     {"all-reduce": 2 * 8 * 16 * F32}, 0),
    # a shard made whole: an all-gather counts its result
    ("shard to replicate", lambda m: sh.redistribute(dtensor((4, 16), [S0, R], m), [R, R]),
     {"all-gather": 8 * 16 * F32}, 0),
    # a partial sum to a shard: a reduce-scatter counts its operand
    ("partial to shard", lambda m: sh.redistribute(dtensor((8, 16), [P, R], m), [S0, R]),
     {"reduce-scatter": 8 * 16 * F32}, 0),
    # a shard of one dim to another: an all-to-all moves the local tensor once
    ("shard to another dim", lambda m: sh.redistribute(dtensor((4, 16), [S0, R], m), [S1, R]),
     {"all-to-all": 4 * 16 * F32}, 0),
    # implicit: a softmax over the sharded dim gathers it inside the op
    ("softmax over a sharded dim", lambda m: torch.softmax(dtensor((8, 8), [S1, R], m), dim=1),
     {"all-gather": 8 * 16 * F32}, 0),
    # rows sharded, the weight replicated: the local product alone, no
    # collective; propagation's FakeTensor product at global shapes (2 x 8 x
    # 16 x 32) is not counted
    ("product on local rows", lambda m: torch.mm(dtensor((4, 16), [S0, R], m),
                                                 dtensor((16, 32), [R, R], m)),
     {}, 2 * 4 * 16 * 32),
]


@pytest.mark.parametrize("name,program,want,flops", PROGRAMS, ids=[p[0] for p in PROGRAMS])
def test_collective_classes_equal_hand_computed_bytes(name, program, want, flops):
    with fake_mesh((2, 2)) as mesh:
        cost = analyze_step(lambda: program(mesh), (), {})
    assert set(cost.collective_bytes) == set(COLLECTIVES)
    assert cost.collective_bytes == {k: float(want.get(k, 0)) for k in COLLECTIVES}, name
    assert cost.total_collective_bytes == sum(want.values())
    assert cost.flops == flops


def test_fake_tensor_ops_count_nothing():
    """Ops on FakeTensors (sharding propagation's shape inference) and
    factories under a FakeTensorMode are not the step's."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def step():
        with FakeTensorMode():
            a, b = torch.empty(8, 16), torch.empty(16, 32)
            return torch.mm(a, b)

    cost = analyze_step(step, (), {})
    assert (cost.flops, cost.n_ops, cost.peak_bytes) == (0, 0, 0)


def test_collective_outside_the_classes_raises():
    for op in (torch.ops._c10d_functional.broadcast.default, torch.ops.c10d.allreduce_.default):
        with pytest.raises(ValueError, match="outside the reference's classes"):
            cost_analysis._collective(op)


# ------------------------------------------------------ steps on a mesh
@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
def test_one_by_one_mesh_counts_as_one_device(kind):
    case = smoke_case("llama2-7b", kind)
    one, mesh = analyze_case(case), mesh_cost(case, (1, 1))
    assert mesh.flops == one.flops and mesh.dot_bytes == one.dot_bytes
    assert mesh.total_collective_bytes == 0
    assert abs(mesh.peak_bytes / one.peak_bytes - 1) <= PEAK_TOL, (mesh.peak_bytes, one.peak_bytes)
    for part in ("params", "moments", "cache", "inputs"):
        assert mesh.parts[part] == one.parts[part], part


# dots that stay replicated over "model" on (2, 2), by (module, function):
# each rank of a "model" row computes them whole for its batch rows
REPLICATED = {
    "llama2-7b": set(), "glm4-9b": set(), "qwen2-vl-72b": set(), "seamless-m4t-large-v2": set(),
    # the router logits and the combine of the picked experts' outputs
    "mixtral-8x22b": {("moe.py", "_route"), ("moe.py", "_combine")},
    # Mamba2's B, C and dt projections (N and nh wide, not "inner") and the
    # intra-chunk C . B product
    "zamba2-7b": {("mamba2.py", "_gates"), ("mamba2.py", "_ssd")},
    # the mLSTM's q/k/v projections, the sLSTM's gate projection and its
    # recurrent product
    "xlstm-1.3b": {("xlstm.py", "_mlstm_proj"), ("xlstm.py", "slstm_forward"),
                   ("xlstm.py", "_slstm_cell")},
}


def dots_by_site(run, rhs=False):
    """{(file, function) of the innermost model frame: dot FLOPs} of a
    forward counted by `run()` (memo off, so every dot runs); with `rhs`
    the key also holds the dot's right operand."""
    by = collections.defaultdict(float)
    real = cost_analysis._Tracker.__torch_dispatch__

    def dispatch(self, func, types, args=(), kwargs=None):
        before = self.flops
        out = real(self, func, types, args, kwargs)
        if self.flops != before:
            # the product's function: a mesh's local version (`_project_local`
            # and its lambda) named as the one-device function (`_project`)
            frames = [f for f in traceback.extract_stack() if "repro_torch/models" in f.filename
                      and f.name != "<lambda>"]
            key = (Path(frames[-1].filename).name, frames[-1].name.removesuffix("_local"))
            if rhs:
                key += (args[cost_analysis.DOT_OPS[func][1]],)
            by[key] += self.flops - before
        return out

    cost_analysis._Tracker.__torch_dispatch__ = dispatch
    try:
        run()
    finally:
        cost_analysis._Tracker.__torch_dispatch__ = real
    return by


@pytest.mark.parametrize("arch", list(REPLICATED))
def test_two_by_two_flops_are_the_whole_split_four_ways(arch):
    """Prefill and train: per-device dot FLOPs x 4 are the one-device count
    within FLOP_TOL, but for the dots that stay replicated, which must be
    those named in REPLICATED (up to twice their count: once a "model"
    rank; zamba2's `_gates` replicates B, C and dt but not x and z). The
    dots are told apart by site (two more passes, memo off) only for the
    families whose count is not the whole split four ways."""
    for kind in ("prefill", "train"):
        case = smoke_case(arch, kind)
        one, four = analyze_case(case).flops, 4 * mesh_cost(case, (2, 2)).flops
        if not REPLICATED[arch]:
            assert abs(four / one - 1) <= FLOP_TOL, (kind, four, one)
        else:  # nothing lost
            assert four >= one * (1 - FLOP_TOL), (kind, four, one)
    if not REPLICATED[arch]:
        return
    case = smoke_case(arch, "prefill")
    whole = dots_by_site(lambda: analyze_case(case, memo=False))
    split = dots_by_site(lambda: mesh_cost(case, (2, 2), memo=False))
    assert set(split) == set(whole)
    replicated = {k for k in whole if abs(4 * split[k] / whole[k] - 1) > FLOP_TOL}
    assert replicated == REPLICATED[arch]
    for k in replicated:  # whole on each of the 2 "model" ranks, or some of its dots
        assert whole[k] < 4 * split[k] <= 2 * whole[k] * (1 + FLOP_TOL), k


REF_SCRIPT = """
import json, os, re, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, {src!r})
import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding
from repro import sharding as sh
from repro.configs import get_config
from repro.launch import specs
from repro.launch.hlo_analysis import analyze_hlo

arch = {arch!r}
smoke = get_config(arch, smoke=True)
specs.get_config = lambda a: smoke
mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
collective = re.compile(r"\\s(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)\\(")
dot = re.compile(r' dot\\(.*op_name="[^"]*/([^/"]+)/dot_general"')
out = {{}}
for label, kind, seq, batch, rules, rt_kwargs in {runs!r}:
    specs.SHAPES["smoke"] = specs.ShapeSpec("smoke", kind, seq, batch)
    case = specs.build_case(arch, "smoke", rules_override=rules and getattr(sh, rules),
                            rt_kwargs=rt_kwargs)
    with sh.use_mesh(mesh, case.rules):
        shardings = tuple(jax.tree.map(lambda s: NamedSharding(mesh, s), sh.tree_specs(a, ax))
                          for a, ax in zip(case.args, case.arg_axes))
        text = jax.jit(case.step, in_shardings=shardings,
                       donate_argnums=case.donate).lower(*case.args).compile().as_text()
    cost = analyze_hlo(text)
    # XLA:CPU runs bf16 dots in f32, and its partitioner moves those f32 copies
    # of the bf16 weights, gradients and activations: the same text with each
    # collective's f32 counted at 2 bytes
    bf16 = analyze_hlo("\\n".join(line.replace("f32[", "bf16[") if collective.search(line)
                                   else line for line in text.splitlines()))
    # dot FLOPs by the einsum each dot comes from (its op_name): the text with
    # every other dot renamed, so that analyze_hlo skips it
    lines = text.splitlines()
    einsums = set(dot.findall(text))
    sites = {{e: analyze_hlo("\\n".join(
        l.replace(" dot(", " skipped-dot(") if " dot(" in l and f"/{{e}}/dot_general" not in l
        else l for l in lines)).flops for e in einsums}}
    out[label] = {{"flops": cost.flops, "collective_bytes": dict(cost.collective_bytes),
                  "at_bf16": dict(bf16.collective_bytes), "sites": sites}}
print(json.dumps(out))
"""
REF_SEQ, REF_BATCH = 16, 4
CP_SEQ = 64  # the context-parallel prefill's tokens: 32 a "model" rank
# the reference's runs: (label, kind, tokens, batch, rule set (None: the kind's),
# RuntimeFlags fields)
REF_RUNS = [(kind, kind, REF_SEQ, REF_BATCH, None, None) for kind in ("prefill", "train", "decode")]
REF_RUNS.append(("prefill_ep_cp", "prefill", CP_SEQ, REF_BATCH, "TRAIN_RULES_EP_CP",
                 {"attn_seq_shard": True}))
REF_RUNS.append(("train_ep_cp", "train", CP_SEQ, REF_BATCH, "TRAIN_RULES_EP_CP",
                 {"attn_seq_shard": True}))
# the reference's collective total at bf16 over the port's, at most (and at least
# 1): the two partitioners move the same step's tensors by different choices,
# and the reference's move more where they differ (PERF.md §6): it gathers
# the FFN and head weights' FSDP shards where DTensor moves the activations
# (all-to-all) and reduce-scatters their partial products, and all-reduces
# the gradients (twice a tensor) where the port reduce-scatters them (once);
# the port gathers the embedding table, which the reference cuts by rows. A
# ratio above it is a collective lost from the count or a new difference to
# account for; below 1, the port moving more than the reference's layout
COLLECTIVE_FACTOR = 2.0


@pytest.fixture(scope="module")
def reference_llama2():
    """The reference's dry run of llama2-7b's smoke REF_RUNS (prefill, train
    and decode steps, and the context-parallel prefill) on a (2, 2) mesh of
    4 host devices, in one subprocess (the device count set before jax
    starts, as `repro/launch/dryrun.py` sets it; a mesh of Auto axes, which
    its sharding constraints need): {label: dot FLOPs, collective bytes by
    class, the same at bf16}."""
    out = subprocess.run([sys.executable, "-c", REF_SCRIPT.format(
        src=str(SRC), arch="llama2-7b", runs=REF_RUNS)],
        capture_output=True, text=True, timeout=400, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("kind", ["prefill", "train", "decode"])
def test_llama2_flops_equal_reference_on_four_host_devices(reference_llama2, kind):
    """Per-device dot FLOPs within FLOP_TOL of the reference's; the
    collective totals within COLLECTIVE_FACTOR, the reference's counted at
    the step's bf16 (for decode either way: the port's decode merges its
    slot-sharded parts by all-reduces of f32, which the reference's f32
    softmax reductions, read at bf16, undercount); the row-parallel
    products' partial sums of a prefill (the output projection's, the
    MLP's, the embedding's) all-reduce the same bytes on both sides."""
    ref = reference_llama2[kind]
    ours = mesh_cost(smoke_case("llama2-7b", kind, REF_SEQ, REF_BATCH), (2, 2))
    ref_total = sum(ref["at_bf16"].values())
    print(f"llama2-7b smoke {kind} {REF_BATCH} x {REF_SEQ} on (2, 2), per device: dot FLOPs "
          f"{ours.flops:.0f} (port) vs {ref['flops']:.0f} (reference); collective bytes "
          f"port {ours.collective_bytes} (total {ours.total_collective_bytes:.0f}), reference "
          f"{ref['collective_bytes']}, at bf16 {ref['at_bf16']} (total {ref_total:.0f}); "
          f"ratio {ref_total / ours.total_collective_bytes:.4f}")
    assert abs(ours.flops / ref["flops"] - 1) <= FLOP_TOL, (ours.flops, ref["flops"])
    low = 1 / COLLECTIVE_FACTOR if kind == "decode" else 1
    assert low <= ref_total / ours.total_collective_bytes <= COLLECTIVE_FACTOR, (
        ref_total, ours.total_collective_bytes)
    if kind == "prefill":
        assert ours.collective_bytes["all-reduce"] == ref["at_bf16"]["all-reduce"]


def test_llama2_decode_collectives_equal_hand_count():
    """llama2-7b smoke (2 layers, d 256, H = K = 8, dh 32, d_ff 512, vocab
    1024, bf16) decoding batch 4 over 64 slots on (2, 2) under DECODE_RULES:
    a device holds 2 rows, 32 slots, 4 heads of each weight and half its
    embed dim. Each class's bytes (an all-gather's result, an all-reduce's
    operand twice, the others' operand) are the hand count's, term by term.
    The cache stays in place: before the merge path the step all-to-all'd
    each layer's K and V shards (2 x 2 x 2 x 32 x 8 x 32 x 2 = 131072 bytes)
    and all-gathered the slot positions (2 x 2 x 64 x 4 = 1024); now q's
    heads are gathered (2048) and the (output, lse) parts all-reduced."""
    L, rows, H, dh, d, V, bf16 = 2, 2, 8, 32, 256, 1024, 2
    case = smoke_case("llama2-7b", "decode", 64, 4)
    cost = mesh_cost(case, (2, 2))
    merge = L * 2 * (rows * H * F32 + rows * H * (dh + 1) * F32)  # max of lse; Σ w o and Σ w
    want = {
        "all-gather": (L * 4 * d * (H // 2) * dh * bf16  # wq, wk, wv, wo: FSDP shards over "data"
                       + L * 3 * rows * H * dh * bf16  # q's heads; the fresh token's k and v
                       + (V // 2) * d * bf16  # the embedding table's FSDP shard
                       + (2 * L + 1) * d * bf16  # the norms' gammas
                       + L * 2 * rows * d * bf16),  # the MLP's down-projection input rows
        "all-reduce": (merge
                       + L * 2 * rows * d * bf16  # the output projection's partial sums
                       + 2 * rows * d * bf16  # the embedding lookup's
                       + L * 2 * 4 * (d // 2) * bf16),  # the MLP's output
        "reduce-scatter": L * 2 * 4 * d * bf16 + 4 * (V // 2) * bf16,  # MLP products; logits
        "all-to-all": L * (2 * rows * d + 4 * (d // 2)) * bf16 + rows * d * bf16,  # MLP; logits
        "collective-permute": 0,
    }
    print(f"llama2-7b smoke decode 4 x 64 on (2, 2), per device: {cost.collective_bytes} "
          f"(merge {merge} of the all-reduce)")
    assert cost.collective_bytes == {k: float(v) for k, v in want.items()}


# the context-parallel step's products by the reference's einsums (the op_name of
# each dot in its compiled HLO): the sites the port's products are held to
REF_SITES = {"bsd,dkh->bskh": "Q/K/V", "bqkgh,bskh->bkgqs": "core", "bkgqs,bskh->bqkgh": "core",
             "bsnh,nhd->bsd": "wo", "...d,df->...f": "gate + up", "...f,fd->...d": "w2",
             "...d,dv->...v": "logits"}


def port_site(cfg, file, function, rhs):
    """The site of one of the port's dots, named as REF_SITES names the
    reference's: by its function, the MLP's by its weight operand."""
    if file == "mlp.py":
        return "w2" if rhs.shape[0] == cfg.d_ff else "gate + up"
    return {"_project": "Q/K/V", "naive_attention": "core", "_out_proj": "wo",
            "logits_from_hidden": "logits"}[function]


def cp_case(kind):
    return smoke_case("llama2-7b", kind, CP_SEQ, REF_BATCH, rules_override=sh.TRAIN_RULES_EP_CP,
                      rt_kwargs={"attn_seq_shard": True})


def test_context_parallel_prefill_against_reference(reference_llama2):
    """llama2-7b smoke prefill, batch 4 over CP_SEQ tokens on (2, 2), under
    TRAIN_RULES_EP_CP with `attn_seq_shard`: each "model" rank computes its
    32 query rows through the attention core (the reference's GSPMD
    partition) and the block's products. Per device, by site: the core's
    dot FLOPs equal the reference's; Q/K/V, gate + up, `wo` and `w2` each
    no more than the reference's (XLA cuts the projections' and gate and
    up's embed dim over "model" where the port cuts their rows, and runs
    `wo` and `w2` whole, which the port runs on rows); the total within
    FLOP_TOL of a four-way cut of one device's count, as under the default
    rules."""
    ref = reference_llama2["prefill_ep_cp"]
    case = cp_case("prefill")
    ours, one = mesh_cost(case, (2, 2)).flops, analyze_case(case).flops
    ref_sites = collections.defaultdict(float)
    for einsum, n in ref["sites"].items():
        ref_sites[REF_SITES[einsum]] += n
    assert sum(ref_sites.values()) == ref["flops"]
    split = collections.defaultdict(float)
    for (f, n, rhs), flops in dots_by_site(lambda: mesh_cost(case, (2, 2), memo=False),
                                           rhs=True).items():
        split[port_site(case.cfg, f, n, rhs)] += flops
    L = case.cfg.n_layers
    print(f"llama2-7b smoke prefill {REF_BATCH} x {CP_SEQ} under TRAIN_RULES_EP_CP with "
          f"attn_seq_shard on (2, 2), per device: dot FLOPs {ours:.0f} (port) vs "
          f"{ref['flops']:.0f} (reference), {one:.0f} on one device; a layer by site, port / "
          "reference: " + ", ".join(f"{k} {split[k] / L:.0f} / {ref_sites[k] / L:.0f}"
                                    for k in ref_sites))
    assert set(split) == set(ref_sites)
    assert abs(split["core"] / ref_sites["core"] - 1) <= FLOP_TOL, (split, ref_sites)
    for site in ("Q/K/V", "gate + up", "wo", "w2"):
        assert split[site] <= ref_sites[site] * (1 + FLOP_TOL), (site, split, ref_sites)
    assert abs(4 * ours / one - 1) <= FLOP_TOL, (ours, one)


def test_context_parallel_prefill_collectives_equal_hand_count(reference_llama2):
    """The same prefill's collectives, class by class the hand count's (a
    device holds 2 rows, 32 query rows, all 8 heads and half of each
    weight's embed dim): the weights' FSDP gathers, K and V gathered over
    the sequence for the core, and, "seq_res" being unmapped under EP_CP,
    each block's attention and MLP outputs gathered by rows at the
    reference's own constraint; the embedding's and logits' as under the
    default rules. `-s` prints the reference's classes beside them."""
    L, rows, S, H, dh, d, f, V, bf16 = 2, 2, CP_SEQ, 8, 32, 256, 512, 1024, 2
    cost = mesh_cost(cp_case("prefill"), (2, 2))
    want = {
        "all-gather": (L * 4 * d * H * dh * bf16  # wq, wk, wv, wo: FSDP shards over "data"
                       + L * 3 * d * f * bf16  # w1, w3, w2
                       + (V // 2) * d * bf16  # the embedding table's FSDP shard
                       + (2 * L + 1) * d * bf16  # the norms' gammas
                       + L * 2 * rows * S * H * dh * bf16  # K and V over the sequence
                       + L * 2 * rows * S * d * bf16),  # the attention's and MLP's outputs
        "all-reduce": 2 * rows * S * d * bf16,  # the embedding lookup's partial sum
        "reduce-scatter": 4 * (V // 2) * bf16,  # logits
        "all-to-all": rows * d * bf16,  # logits
        "collective-permute": 0,
    }
    ref = reference_llama2["prefill_ep_cp"]
    print(f"llama2-7b smoke prefill {REF_BATCH} x {CP_SEQ} under TRAIN_RULES_EP_CP with "
          f"attn_seq_shard on (2, 2), per device: port {cost.collective_bytes}, reference "
          f"{ref['collective_bytes']}, at bf16 {ref['at_bf16']}")
    assert cost.collective_bytes == {k: float(v) for k, v in want.items()}


def test_context_parallel_train_no_more_than_reference(reference_llama2):
    """The same rules' train step (loss, gradients and AdamW, 4 x CP_SEQ on
    (2, 2)): the port's per-device dot FLOPs no more than the reference's."""
    ref = reference_llama2["train_ep_cp"]
    ours = mesh_cost(cp_case("train"), (2, 2)).flops
    print(f"llama2-7b smoke train {REF_BATCH} x {CP_SEQ} under TRAIN_RULES_EP_CP with "
          f"attn_seq_shard on (2, 2), per device: dot FLOPs {ours:.0f} (port) vs "
          f"{ref['flops']:.0f} (reference)")
    assert ours <= ref["flops"] * (1 + FLOP_TOL), (ours, ref["flops"])


def collectives_by_op(run):
    """{op name: launches} of the collectives the counter counts in `run()`."""
    seen = collections.Counter()
    real = cost_analysis._Tracker.__torch_dispatch__

    def dispatch(self, func, types, args=(), kwargs=None):
        out = real(self, func, types, args, kwargs)
        info = self.info.get(func)
        if out is not NotImplemented and info is not None and info[2] is not None:
            seen[func._schema.name.split("::")[-1]] += 1
        return out

    cost_analysis._Tracker.__torch_dispatch__ = dispatch
    try:
        run()
    finally:
        cost_analysis._Tracker.__torch_dispatch__ = real
    return seen


@pytest.mark.parametrize("arch,kind", [("llama2-7b", "prefill"), ("llama2-7b", "train"),
                                       ("llama2-7b", "decode"), ("mixtral-8x22b", "train")])
def test_no_collective_escapes_the_count(arch, kind):
    """The same step on the same mesh under `CommDebugMode` (which counts
    every functional and c10d collective and `shard_dim_alltoall`) launches
    the collectives the counter counted, op for op."""
    from torch.distributed.tensor.debug import CommDebugMode

    case = smoke_case(arch, kind)
    ours = collectives_by_op(lambda: mesh_cost(case, (2, 2)))
    with fake_mesh((2, 2)) as mesh, sh.use_mesh(mesh, case.rules):
        args = dryrun._on_mesh(case)
        with CommDebugMode() as comm:
            case.step(*args)
    theirs = collections.Counter({str(op).split(".")[-1]: n
                                  for op, n in comm.get_comm_counts().items()})
    assert ours and ours == theirs, (ours, theirs)


def test_redistribute_direct_path_and_gloo_detour_agree():
    """Every redistribution of an (8, 8, 8) tensor on a (2, 2) mesh between
    placements of Replicate, Partial and a shard of each dim (nested shards
    too): DTensor's direct path (NCCL's and the fake backend's) and the gloo
    detour give the same placements, global and local shapes, and so does
    the way back (`run_local`'s write-back of an in-place argument)."""
    pls = [R, P, S0, S1, Shard(2)]
    with fake_mesh((2, 2)) as mesh:
        assert sh.redistribute(dtensor((4, 8, 8), [S0, R], mesh), [S1, R]).placements == (S1, R)
        for src in itertools.product(pls, repeat=2):
            local = [8, 8, 8]
            for pl in src:
                if isinstance(pl, Shard):
                    local[pl.dim] //= 2
            x = dtensor(local, list(src), mesh)
            for want in itertools.product(pls[:1] + pls[2:], repeat=2):
                if want == src:
                    continue
                direct, detour = x.redistribute(mesh, want), sh._whole_then_cut(x, want)
                assert direct.placements == detour.placements == want, (src, want)
                assert direct.shape == detour.shape == x.shape, (src, want)
                assert direct.to_local().shape == detour.to_local().shape, (src, want)
                if P not in src:
                    back = (direct.redistribute(mesh, src), sh._whole_then_cut(direct, src))
                    assert all(b.placements == src and b.to_local().shape == x.to_local().shape
                               for b in back), (src, want)


# ------------------------------------------------------------ the flags
def reference_flags():
    """(--rules choices, --moe-dispatch choices, {override name: table name})
    of `repro/launch/dryrun.py`, read from its source (importing it would
    set this process's XLA device count)."""
    tree = ast.parse((SRC / "repro" / "launch" / "dryrun.py").read_text())
    choices, tables = {}, {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument":
            flag = node.args[0].value
            for kw in node.keywords:
                if kw.arg == "choices" and isinstance(kw.value, ast.List):
                    choices[flag] = [e.value for e in kw.value.elts]
        if isinstance(node, ast.Dict) and any(isinstance(k, ast.Constant) and k.value == "train_sp"
                                              for k in node.keys):
            tables = {k.value: v.attr for k, v in zip(node.keys, node.values)
                      if isinstance(k, ast.Constant) and k.value is not None}
    return choices["--rules"], choices["--moe-dispatch"], tables


def test_rules_and_dispatch_choices_equal_reference():
    rules, dispatch, tables = reference_flags()
    assert list(dryrun.RULES) == rules and len(rules) == 9
    assert dryrun.RULES == tables
    for table in tables.values():
        assert getattr(sh, table) == getattr(ref_sh, table), table
    ap_choices = {a.dest: a.choices for a in dryrun.parser()._actions}
    assert list(ap_choices["rules"]) == rules and list(ap_choices["moe_dispatch"]) == dispatch


SMALL = {"single": ((2, 2), ("data", "model"))}
# (flags: --rules, RuntimeFlags fields, arch, kind): every override once, on a
# family it applies to, context-parallel sets with --attn-seq-shard as the
# reference pairs them; both moe dispatches
OVERRIDES = [
    ("train_sp", {}, "llama2-7b", "train"),
    ("decode_v2", {}, "llama2-7b", "decode"),
    ("train_attnsp", {"attn_seq_shard": True}, "llama2-7b", "train"),
    ("train_cp_sp", {"attn_seq_shard": True}, "glm4-9b", "train"),
    ("decode_v3", {}, "glm4-9b", "decode"),
    ("train_fsdp", {}, "llama2-7b", "train"),
    ("train_ep_cp", {"attn_seq_shard": True}, "mixtral-8x22b", "train"),
    ("train_ep_cp_sp", {"attn_seq_shard": True}, "mixtral-8x22b", "train"),
    ("decode_v3_ep", {}, "mixtral-8x22b", "decode"),
    (None, {"moe_dispatch": "einsum"}, "mixtral-8x22b", "train"),
    (None, {"moe_dispatch": "scatter"}, "mixtral-8x22b", "train"),
]


@pytest.mark.parametrize("rules,flags,arch,kind", OVERRIDES,
                         ids=[f"{r or 'kind'}-{a}-{k}-{'-'.join(map(str, f.values()))}"
                              for r, f, a, k in OVERRIDES])
def test_each_override_runs_a_smoke_case(monkeypatch, rules, flags, arch, kind):
    monkeypatch.setattr(dryrun, "MESHES", SMALL)
    smoke = get_config(arch, smoke=True)
    fields = {f.name: getattr(smoke, f.name) for f in dataclasses.fields(smoke)}
    rec = dryrun.run_case(arch, ShapeSpec(f"{kind}_16", kind, 16, 4), out_dir=None,
                          rt_kwargs=flags or None, cfg_kwargs=fields, mesh="single",
                          rules=rules, tag=rules or "")
    assert rec["status"] == "ok", rec.get("traceback")
    want = dryrun.RULES[rules] if rules else dryrun.KIND_RULES[kind]
    assert rec["rules"] == want and rec["flags"] == flags and rec["chips"] == 4
    assert rec["cost"]["flops"] > 0 and rec["memory"]["peak_gb"] > 0
    assert set(rec["cost"]["collective_bytes"]) == set(COLLECTIVES)
    assert rec["roofline"]["collective_s"] == pytest.approx(
        sum(rec["cost"]["collective_bytes"].values()) / rec["cost"]["link_bw"])


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_attn_seq_shard_shards_the_output_by_query_seq(monkeypatch, kind):
    """Under TRAIN_RULES_ATTNSP with `attn_seq_shard`, the attention output
    that reaches the output projection is sharded on its query-seq dim
    over "model"; without the flag it is sharded by heads."""
    seen = []
    real = attention._out_proj
    monkeypatch.setattr(attention, "_out_proj",
                        lambda out, wo: (seen.append(tuple(out.placements)), real(out, wo))[1])
    for flag in (True, False):
        case = smoke_case("llama2-7b", kind, rules_override=sh.TRAIN_RULES_ATTNSP,
                          rt_kwargs={"attn_seq_shard": flag})
        seen.clear()
        mesh_cost(case, (2, 2))
        assert seen and all(pl == (S0, Shard(1) if flag else Shard(2)) for pl in seen), seen
