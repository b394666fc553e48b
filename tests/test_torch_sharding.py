"""The port's sharding layer (`repro_torch.sharding`, `launch.mesh`) against
the reference's `repro.sharding` on the CPU.

Resolution is arithmetic on axis names and sizes: the port's `spec_for`
reads a torch `DeviceMesh` built over a process group on the `fake`
backend (256 or 512 ranks, nothing communicated), the reference's an
`AbstractMesh`; the specs must be equal entry for entry. The rule tables,
the reference's own resolution cases, a seeded sweep of shapes x presets x
meshes, the axes of every parameter and cache leaf of every arch, the
specs of every argument leaf of every assigned arch x shape on the two
production meshes and the per-device argument bytes the dry run counts
from them are held equal; then the DTensor placements and `constrain`.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from conftest import ASSIGNED_ARCHS, abstract_mesh  # noqa: E402
from torch.distributed.device_mesh import init_device_mesh  # noqa: E402
from torch.distributed.tensor import Replicate, Shard, distribute_tensor  # noqa: E402

from repro import sharding as ref_sh  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import list_configs  # noqa: E402
from repro.launch import specs as ref_specs  # noqa: E402
from repro.models import RuntimeFlags as JaxFlags  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch import sharding as sh  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import reference_key  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import specs as port_specs  # noqa: E402
from repro_torch.launch.mesh import MULTI, SINGLE, fake_process_group  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

# the reference's rule tables by their names there, the port's by the same
TABLES = ["TRAIN_RULES", "TRAIN_RULES_SP", "TRAIN_RULES_ATTNSP", "TRAIN_RULES_CP_SP",
          "TRAIN_RULES_FSDP", "TRAIN_RULES_EP_CP", "TRAIN_RULES_EP_CP_SP", "PREFILL_RULES",
          "DECODE_RULES", "DECODE_RULES_V2", "DECODE_RULES_V3", "DECODE_RULES_V3_EP"]
MESHES = {"1x1": ((1, 1), ("data", "model")), "2x2": ((2, 2), ("data", "model")),
          "16x16": SINGLE, "2x16x16": MULTI}
LOGICAL = ["batch", "seq", "embed", "heads", "kv_heads", "ffn", "vocab", "experts", "kv_seq",
           "kv_batch", "inner", "seq_res", "attn_q_seq", "p_embed", "p_vocab", "p_heads",
           "p_kv_heads", "p_ffn", "p_inner", "p_experts", None]
SHAPES = list(port_specs.SHAPES)


def port_mesh(name):
    """A context: the port's mesh `name` over a fake process group."""
    shape, names = MESHES[name]

    class _Mesh:
        def __enter__(self):
            self.pg = fake_process_group(int(np.prod(shape)))
            self.pg.__enter__()
            return init_device_mesh("cpu", shape, mesh_dim_names=names)

        def __exit__(self, *a):
            return self.pg.__exit__(*a)

    return _Mesh()


class _RefCtx:
    """The reference's (mesh, rules) on its AbstractMesh `name`, set for
    spec_for and tree_specs (its `use_mesh` enters the mesh too, which an
    AbstractMesh need not allow)."""

    def __init__(self, name, rules):
        shape, names = MESHES[name]
        self.ctx = ref_sh._Ctx(abstract_mesh(shape, names), rules)

    def __enter__(self):
        self.token = ref_sh._ctx.set(self.ctx)

    def __exit__(self, *a):
        ref_sh._ctx.reset(self.token)


# ---------------------------------------------------------------------------
# rule tables and resolution
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("table", TABLES)
def test_rule_table_equals_reference(table):
    assert getattr(sh, table) == getattr(ref_sh, table)


@pytest.mark.parametrize("table", TABLES)
def test_rule_tuples_follow_the_mesh_order(table):
    """No preset names mesh axes out of the mesh's order, so every spec
    turns into DTensor placements (`placements_for` raises otherwise)."""
    order = MULTI[1]
    for cand in getattr(sh, table).values():
        assert [order.index(a) for a in cand] == sorted(order.index(a) for a in cand)


def test_placements_refuse_an_out_of_order_tuple():
    with port_mesh("2x2") as mesh:
        with pytest.raises(ValueError, match="order"):
            sh.placements_for(sh.PartitionSpec(("model", "data")), mesh)
        assert sh.placements_for(sh.PartitionSpec(("data", "model")), mesh) == (Shard(0), Shard(0))


class TestReferenceCases:
    """The reference's own cases (tests/test_components.py::TestSharding,
    tests/test_launch.py::TestDecodeRulesV3)."""

    def test_spec_resolution_on_one_device(self):
        with port_mesh("1x1") as mesh, sh.use_mesh(mesh, sh.TRAIN_RULES):
            assert sh.spec_for((8, 16), ("batch", "ffn")) == sh.PartitionSpec("data", "model")

    def test_divisibility_fallback_replicates(self):
        with port_mesh("2x2") as mesh:
            ctx = sh._Ctx(mesh, sh.TRAIN_RULES)
            assert sh._resolve_dim(7, "ffn", ctx, set()) is None
            assert sh._resolve_dim(8, "ffn", ctx, set()) == "model"

    def test_axis_used_once(self):
        with port_mesh("2x2") as mesh:
            ctx = sh._Ctx(mesh, sh.TRAIN_RULES)
            used = set()
            a = sh._resolve_dim(8, "ffn", ctx, used)
            b = sh._resolve_dim(8, "heads", ctx, used)
            assert a == "model" and b is None

    def test_v3_embed_over_data(self):
        with port_mesh("16x16") as mesh:
            ctx = sh._Ctx(mesh, sh.DECODE_RULES_V3)
            assert sh._resolve_dim(8192, "embed", ctx, set()) == "data"
            assert sh._resolve_dim(128, "batch", ctx, set()) is None

    def test_no_mesh_gives_the_empty_spec(self):
        assert sh.spec_for((8, 16), ("batch", "ffn")) == sh.PartitionSpec() == ()


def _sweep(seed, n=300):
    """n (shape, axes) pairs: 1-5 dims of sizes that divide by 1-512 or not."""
    rng = np.random.default_rng(seed)
    sizes = [1, 2, 3, 7, 8, 16, 24, 32, 48, 64, 96, 128, 256, 512, 1000, 1024, 4096, 8192,
             32768, 151552]
    out = []
    for _ in range(n):
        nd = int(rng.integers(1, 6))
        shape = tuple(int(rng.choice(sizes)) for _ in range(nd))
        axes = tuple(LOGICAL[int(rng.integers(len(LOGICAL)))] for _ in range(nd))
        out.append((shape, axes))
    return out


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("table", TABLES)
def test_spec_sweep_equals_reference(mesh_name, table):
    cases = _sweep(seed=TABLES.index(table) * 10 + list(MESHES).index(mesh_name))
    with _RefCtx(mesh_name, getattr(ref_sh, table)):
        want = [tuple(ref_sh.spec_for(s, a)) for s, a in cases]
    with port_mesh(mesh_name) as mesh, sh.use_mesh(mesh, getattr(sh, table)):
        got = [sh.spec_for(s, a) for s, a in cases]
    assert got == want


# ---------------------------------------------------------------------------
# the axes of every parameter and cache leaf
# ---------------------------------------------------------------------------


def _ref_leaves(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_ref_leaves(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _drop_stacked(name, axes_tree_leaves):
    """The reference leaf of port parameter `name`, its stacked layer axes
    (unsharded: None) dropped."""
    path, idx = reference_key(name)
    ref = tuple(axes_tree_leaves[path])
    assert all(a is None for a in ref[:len(idx)]), (name, ref)
    return path, ref[len(idx):]


@pytest.mark.parametrize("arch", list_configs())
def test_param_axes_equal_reference(arch):
    cfg_j = dataclasses.replace(jax_get_config(arch, smoke=True), dtype="float32")
    box = {}

    def init(k):
        p, a = jax_build_model(cfg_j, JaxFlags()).init(k)
        box["axes"] = a
        return p

    jax.eval_shape(init, jax.random.PRNGKey(0))
    ref = _ref_leaves(box["axes"])
    model = build_model(get_config(arch, smoke=True))
    params = model.init(device="meta")
    axes = model.param_axes(params)
    hit = set()
    for name, p in params.named_parameters():
        path, want = _drop_stacked(name, ref)
        assert tuple(axes[name]) == want, name
        assert len(axes[name]) == p.dim(), name
        hit.add(path)
    assert hit == set(ref)  # every reference leaf is some port parameter's


@pytest.mark.parametrize("arch", list_configs())
def test_cache_axes_equal_reference(arch):
    cfg_j = dataclasses.replace(jax_get_config(arch, smoke=True), dtype="float32")
    mj = jax_build_model(cfg_j, JaxFlags())
    box = {}

    def init():
        c, a = mj.init_cache(2, 16, enc_len=8 if cfg_j.n_encoder_layers else 0)
        box["axes"] = a
        return c

    ref_cache = jax.eval_shape(init)
    model = build_model(get_config(arch, smoke=True))
    axes = model.cache_axes(2, 16, 8)
    got, want = _ref_leaves(axes), _ref_leaves(box["axes"])
    assert {k: tuple(v) for k, v in got.items()} == {k: tuple(v) for k, v in want.items()}
    cache = model.init_cache(2, 16, device="meta", enc_len=8)
    shapes = {k: tuple(v.shape) for k, v in _ref_leaves(cache).items()}
    assert shapes == {k: tuple(v.shape) for k, v in _ref_leaves(ref_cache).items()}
    assert all(len(got[k]) == len(shapes[k]) for k in got)


# ---------------------------------------------------------------------------
# every argument leaf of every assigned case on the production meshes
# ---------------------------------------------------------------------------

_CASES = {}


def cases(arch, shape):
    """(the reference's case, the port's case), built once."""
    if (arch, shape) not in _CASES:
        _CASES[(arch, shape)] = (ref_specs.build_case(arch, shape),
                                 port_specs.build_case(arch, shape))
    return _CASES[(arch, shape)]


def _ref_flat(tree, prefix=()):
    """{path: leaf} of a reference tree (dicts; tuples by position)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_ref_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _ref_bytes(arg, spec, sizes) -> int:
    return sum(sh.local_numel(a.shape, tuple(s), sizes) * np.dtype(a.dtype).itemsize
               for a, s in zip(jax.tree.leaves(arg), jax.tree.leaves(
                   spec, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))))


# every assigned arch x shape but the documented skip (seamless x long_500k)
CASES = [(a, s) for a in ASSIGNED_ARCHS for s in SHAPES
         if not port_specs.skip_reason(get_config(a), port_specs.SHAPES[s])]


@pytest.mark.parametrize("mesh_name", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch,shape", CASES)
def test_case_specs_and_bytes_equal_reference(arch, shape, mesh_name):
    ref, port = cases(arch, shape)
    assert port.rules == ref.rules
    with _RefCtx(mesh_name, ref.rules):
        ref_specs_ = [ref_sh.tree_specs(a, ax) for a, ax in zip(ref.args, ref.arg_axes)]
    with port_mesh(mesh_name) as mesh:
        with sh.use_mesh(mesh, port.rules):
            port_specs_ = [sh.tree_specs(a, ax) for a, ax in zip(port.args, port.arg_axes)]
        got_bytes = dryrun.argument_bytes(port, mesh)
        sizes = sh.mesh_sizes(mesh)
    parts = port.arg_parts
    assert len(parts) == len(port.args) == len(ref.args)
    want_bytes = dict.fromkeys(dryrun.PARTS, 0)
    for i, part in enumerate(parts):
        want_bytes[part] += _ref_bytes(ref.args[i], ref_specs_[i], sizes)
        if part == "params":  # by name, stacked axes dropped
            ref_leaves = _ref_flat(ref_specs_[i])
            for name, spec in port_specs_[i].items():
                _, want = _drop_stacked(name, ref_leaves)
                assert tuple(spec) == want, name
        elif part == "moments":
            ref_leaves = _ref_flat(ref_specs_[i])
            for moment in ("mu", "nu"):
                for name, spec in port_specs_[i][moment].items():
                    path, idx = reference_key(name)
                    full = tuple(ref_leaves[(moment,) + path])
                    assert tuple(spec) == full[len(idx):], (moment, name)
            assert tuple(port_specs_[i]["step"]) == tuple(ref_leaves[("step",)])
        else:
            got_l, want_l = _ref_flat(port_specs_[i]), _ref_flat(ref_specs_[i])
            assert {k: tuple(v) for k, v in got_l.items()} == \
                {k: tuple(v) for k, v in want_l.items()}
    assert got_bytes == want_bytes


# ---------------------------------------------------------------------------
# DTensor placements and constrain
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("table", ["TRAIN_RULES", "DECODE_RULES", "TRAIN_RULES_FSDP"])
def test_placements_give_local_shapes(table):
    """On the fake 16x16 mesh each dim's local size is its size over the
    product of its entry's axes (meta tensors: nothing is allocated)."""
    rules = getattr(sh, table)
    cases = [((256, 4096, 8192), ("batch", "seq", "embed")),
             ((4096, 32, 128), ("p_embed", "p_heads", None)),
             ((32, 128, 32768, 8, 128), ("layers", "kv_batch", "kv_seq", "kv_heads", None)),
             ((152064, 8192), ("p_vocab", "p_embed")), ((7, 48), ("batch", "ffn"))]
    with port_mesh("16x16") as mesh, sh.use_mesh(mesh, rules):
        sizes = sh.mesh_sizes(mesh)
        for shape, axes in cases:
            spec = sh.spec_for(shape, axes)
            sharding = sh.sharding_for(shape, axes)
            assert sharding.mesh is mesh and sharding.spec == spec
            x = distribute_tensor(torch.empty(shape, device="meta"), mesh, sharding.placements)
            want = tuple(d // int(np.prod([sizes[a] for a in sh._entry_axes(e)]))
                         for d, e in zip(shape, tuple(spec) + (None,) * len(shape)))
            assert tuple(x.to_local().shape) == want, (shape, axes, spec)


def test_production_meshes():
    for multi, (shape, names) in ((False, SINGLE), (True, MULTI)):
        with fake_process_group(int(np.prod(shape))):
            mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
            assert tuple(mesh.shape) == shape and mesh.mesh_dim_names == names


def test_constrain_is_the_identity_off_a_mesh():
    x = torch.randn(4, 8)
    assert sh.constrain(x, ("batch", "embed")) is x
    assert sh.on_mesh(x, ("batch", "embed")) is x
    assert sh.current_mesh() is None


def test_constrain_refuses_a_plain_tensor_under_a_mesh():
    with port_mesh("2x2") as mesh, sh.use_mesh(mesh, sh.TRAIN_RULES):
        with pytest.raises(TypeError, match="escaped"):
            sh.constrain(torch.randn(4, 8), ("batch", "embed"))
        x = sh.on_mesh(torch.empty(4, 8, device="meta"), ("batch", "ffn"))
        assert tuple(x.placements) == (Shard(0), Shard(1))
        y = sh.constrain(x, ("batch", None))
        assert tuple(y.placements) == (Shard(0), Replicate())
        assert sh.constrain(y, ("batch", None)) is y


def test_param_axes_follow_the_parameters():
    """`param_axes` reads each parameter's own axes: they survive
    `convert_params` and `distribute_params`, and a copy that lost them is
    refused rather than guessed."""
    import copy

    from repro_torch.convert import convert_params, export_params

    model = build_model(dataclasses.replace(get_config("llama2-7b", smoke=True),
                                            dtype="float32"))
    params = model.init(seed=0, device="cpu")
    want = model.param_axes(params)
    assert model.param_axes(convert_params(export_params(params), model.cfg, "cpu")) == want
    with port_mesh("2x2") as mesh, sh.use_mesh(mesh, sh.PREFILL_RULES):
        assert model.param_axes(sh.distribute_params(params, want)) == want
    with pytest.raises(ValueError, match="without logical axes"):
        model.param_axes(copy.deepcopy(params))
