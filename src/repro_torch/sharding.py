"""Rule-based logical-axis sharding on a torch `DeviceMesh` (the port's copy
of `repro/sharding.py`).

Model code never names mesh axes. Tensors (parameters, caches and
activations) carry *logical* axis names ("batch", "ffn", "kv_seq", ...); a
rule table maps each logical name to an ordered tuple of mesh axes.
`spec_for()` resolves a concrete shape to a `PartitionSpec`, enforcing

  * divisibility: a dim is only sharded by a (prefix of the) mesh-axis
    tuple whose total size divides it, else it falls back to replication,
  * uniqueness: a mesh axis is consumed at most once per spec,

so every (arch x shape x mesh) combination resolves: the worst case is
replication, never a crash. Resolution reads only the mesh's
`mesh_dim_names` and sizes, so it equals the reference's entry for entry.

Execution is DTensor's: `placements_for` turns a spec into one placement a
mesh dim, `distribute_params` / `distribute_tree` / `on_mesh` put tensors
on the mesh by their axes (what jit's `in_shardings` does in the
reference), and `constrain` redistributes a DTensor to the placements its
axes resolve to (the reference's `with_sharding_constraint`).

Use:

    with use_mesh(mesh, PREFILL_RULES):
        spec = spec_for((32, 32768, 4096), ("batch", "seq", "embed"))
        x = constrain(x, ("batch", "seq", "embed"))   # identity with no mesh
"""

from __future__ import annotations

import contextlib
import contextvars
import copy
import dataclasses
import functools
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Placement, Replicate, Shard

__all__ = [
    "AxisRules",
    "TRAIN_RULES",
    "TRAIN_RULES_SP",
    "TRAIN_RULES_ATTNSP",
    "TRAIN_RULES_CP_SP",
    "TRAIN_RULES_FSDP",
    "TRAIN_RULES_EP_CP",
    "TRAIN_RULES_EP_CP_SP",
    "PREFILL_RULES",
    "DECODE_RULES",
    "DECODE_RULES_V2",
    "DECODE_RULES_V3",
    "DECODE_RULES_V3_EP",
    "PartitionSpec",
    "Axes",
    "use_mesh",
    "current_mesh",
    "bound",
    "mesh_sizes",
    "spec_for",
    "placements_for",
    "sharding_for",
    "Sharding",
    "placements_of",
    "dims_sharding",
    "shard_index",
    "shard_start",
    "placed",
    "redistribute",
    "run_local",
    "write_slots",
    "constrain",
    "on_mesh",
    "replicated_like",
    "whole",
    "tree_specs",
    "local_bytes",
    "local_numel",
    "distribute_params",
    "distribute_tree",
]

# logical name -> ordered mesh-axis candidates (joined, in order, while they
# divide the dim). Missing name == replicated.
AxisRules = Dict[str, Tuple[str, ...]]

# ---------------------------------------------------------------------------
# Rule presets, key for key the reference's.
#
# Activation axes: batch, seq, embed, heads, kv_heads, head_dim, ffn, vocab,
#                  experts, capacity, kv_seq, inner, state
# Param axes are prefixed p_ where their placement differs from the
# activation of the same name (FSDP: shard params' embed dim over the data
# axis; they are all-gathered on use).
# ---------------------------------------------------------------------------

TRAIN_RULES: AxisRules = {
    # activations ("seq_res" = the residual stream between blocks; mapping it
    # to ("model",) turns on Megatron-style sequence parallelism)
    "batch": ("pod", "data"),
    "heads": ("model",),
    "kv_heads": ("model",),
    "ffn": ("model",),
    "inner": ("model",),
    "vocab": ("model",),
    "experts": (),
    # params (TP on model axis + FSDP on data axis along p_embed)
    "p_embed": ("data",),
    "p_vocab": ("model",),
    "p_heads": ("model",),
    "p_kv_heads": ("model",),
    "p_ffn": ("model",),
    "p_inner": ("model",),
    "p_experts": (),
}

# + sequence-parallel residual stream.
TRAIN_RULES_SP: AxisRules = dict(TRAIN_RULES, seq_res=("model",))

# Context-parallel attention: the attention core shards by query sequence.
TRAIN_RULES_ATTNSP: AxisRules = dict(TRAIN_RULES, attn_q_seq=("model",))

# Context-parallel attention + sequence-parallel residual combined.
TRAIN_RULES_CP_SP: AxisRules = dict(
    TRAIN_RULES, attn_q_seq=("model",), seq_res=("model",)
)

# Pure FSDP (ZeRO-3 style): batch over the whole mesh, no tensor parallelism;
# every parameter shards along its embed dim over data and model.
TRAIN_RULES_FSDP: AxisRules = {
    "batch": ("pod", "data", "model"),
    "heads": (), "kv_heads": (), "ffn": (), "inner": (), "vocab": (),
    "experts": (),
    "p_embed": ("data", "model"),
    "p_vocab": (), "p_heads": (), "p_kv_heads": (), "p_ffn": (),
    "p_inner": (), "p_experts": (),
}

# Expert-parallel MoE + context-parallel attention.
TRAIN_RULES_EP_CP: AxisRules = {
    **TRAIN_RULES,
    "experts": ("model",),
    "p_experts": ("model",),
    "attn_q_seq": ("model",),
    "heads": (), "kv_heads": (), "ffn": (),
    "p_heads": (), "p_kv_heads": (), "p_ffn": (),
}

# ... + sequence-parallel residual.
TRAIN_RULES_EP_CP_SP: AxisRules = dict(TRAIN_RULES_EP_CP, seq_res=("model",))

# Serving prefill: the training placement (weights stationary, batch DP).
PREFILL_RULES: AxisRules = dict(TRAIN_RULES)

# Serving decode: the cache's sequence over the model axis, batch over data.
DECODE_RULES: AxisRules = dict(
    TRAIN_RULES,
    kv_seq=("model",),
    kv_batch=("pod", "data"),
)

# Per-token activations replicated over the data axis.
DECODE_RULES_V2: AxisRules = {
    **DECODE_RULES,
    "batch": (),
    "heads": ("model",),
}

# + the per-token activations' embed dim over the data axis.
DECODE_RULES_V3: AxisRules = {
    **DECODE_RULES_V2,
    "embed": ("data",),
}

# V3 + expert-parallel decode.
DECODE_RULES_V3_EP: AxisRules = {
    **DECODE_RULES_V3,
    "experts": ("model",),
    "p_experts": ("model",),
}

class PartitionSpec(tuple):
    """One entry a tensor dim: None (replicated), a mesh-axis name, or a
    tuple of names (sharded over their product, in that order). Equal entry
    for entry to the reference's `jax.sharding.PartitionSpec`."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:  # pragma: no cover
        return f"PartitionSpec{tuple.__repr__(self)}"


class Axes(tuple):
    """Logical-axis annotation for one tensor: an axes tree (same structure
    as a name-keyed tree of tensors, `Axes` leaves) maps 1:1 onto it."""

    def __repr__(self) -> str:  # pragma: no cover
        return f"Axes{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class _Ctx:
    mesh: DeviceMesh
    rules: AxisRules

    @property
    def sizes(self) -> Dict[str, int]:
        return mesh_sizes(self.mesh)


_ctx: contextvars.ContextVar[Optional[_Ctx]] = contextvars.ContextVar(
    "sharding_ctx", default=None
)


def mesh_sizes(mesh: DeviceMesh) -> Dict[str, int]:
    """{mesh-axis name: size} in the mesh's order."""
    if mesh.mesh_dim_names is None:
        raise ValueError("the mesh needs mesh_dim_names (the rule tables name its axes)")
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@contextlib.contextmanager
def use_mesh(mesh: DeviceMesh, rules: AxisRules):
    """Activate (mesh, rules) for spec resolution, constraints and the
    models' entry points."""
    mesh_sizes(mesh)
    token = _ctx.set(_Ctx(mesh, rules))
    try:
        yield
    finally:
        _ctx.reset(token)


def current_mesh() -> Optional[DeviceMesh]:
    c = _ctx.get()
    return c.mesh if c is not None else None


def bound(fn):
    """`fn` run under the mesh and rules active now, wherever it is called:
    a remat checkpoint's recompute runs in the backward, which on the card
    runs in autograd's device thread, where the caller's `use_mesh` is not
    seen (on the CPU the backward runs in the caller's thread). `fn` itself
    with no mesh."""
    c = _ctx.get()
    if c is None:
        return fn

    @functools.wraps(fn)
    def run(*args, **kwargs):
        token = _ctx.set(c)
        try:
            return fn(*args, **kwargs)
        finally:
            _ctx.reset(token)

    return run


def _resolve_dim(dim: int, name: Optional[str], ctx: _Ctx, used: set):
    """Longest prefix of the rule tuple that exists in the mesh, divides
    `dim`, and does not reuse a mesh axis."""
    if name is None:
        return None
    sizes = ctx.sizes
    cand = ctx.rules.get(name, ())
    chosen = []
    size = 1
    for ax in cand:
        if ax not in sizes or ax in used:
            continue
        nxt = size * sizes[ax]
        if dim % nxt != 0:
            break
        chosen.append(ax)
        size = nxt
    if not chosen:
        return None
    used.update(chosen)
    return tuple(chosen) if len(chosen) > 1 else chosen[0]


def spec_for(shape: Sequence[int], axes: Sequence[Optional[str]]) -> PartitionSpec:
    """Resolve logical axes for a concrete shape to a PartitionSpec."""
    ctx = _ctx.get()
    if ctx is None:
        return PartitionSpec()
    assert len(shape) == len(axes), (shape, axes)
    used: set = set()
    return PartitionSpec(*[_resolve_dim(d, a, ctx, used) for d, a in zip(shape, axes)])


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placements_for(spec: Sequence, mesh: DeviceMesh) -> Tuple[Placement, ...]:
    """One DTensor placement a mesh dim: Shard(d) on each mesh dim that
    tensor dim d's entry names, Replicate on the others. A dim sharded over
    several mesh axes ("pod", "data") is split over them in the mesh's
    order, which is DTensor's; an entry naming them in another order
    raises."""
    names = list(mesh_sizes(mesh))
    out: List[Placement] = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        idx = [names.index(ax) for ax in _entry_axes(entry)]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's order {tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """The counterpart of `NamedSharding`: the mesh, the spec and the
    placements it resolves to."""

    mesh: DeviceMesh
    spec: PartitionSpec
    placements: Tuple[Placement, ...]


def sharding_for(shape: Sequence[int], axes: Sequence[Optional[str]]) -> Optional[Sharding]:
    ctx = _ctx.get()
    if ctx is None:
        return None
    spec = spec_for(shape, axes)
    return Sharding(ctx.mesh, spec, placements_for(spec, ctx.mesh))


def constrain(x: torch.Tensor, axes: Sequence[Optional[str]]) -> torch.Tensor:
    """Under an active mesh, `x` (a DTensor) redistributed to the placements
    its axes resolve to; the identity with no mesh. A plain tensor under a
    mesh has escaped it: that raises."""
    ctx = _ctx.get()
    if ctx is None:
        return x
    if not isinstance(x, DTensor):
        raise TypeError(f"constrain{tuple(axes)}: a plain tensor {tuple(x.shape)} under a "
                        "mesh (it escaped the mesh; bring it on with on_mesh)")
    return redistribute(x, placements_for(spec_for(x.shape, axes), ctx.mesh))


def on_mesh(x: torch.Tensor, axes: Sequence[Optional[str]]) -> torch.Tensor:
    """A tensor entering the mesh by its axes: a plain tensor, the same on
    every rank, is distributed (each rank keeps its shard); a DTensor is
    constrained. The identity with no mesh."""
    ctx = _ctx.get()
    if ctx is None:
        return x
    if isinstance(x, DTensor):
        return constrain(x, axes)
    return _distribute(x, ctx.mesh, placements_for(spec_for(x.shape, axes), ctx.mesh))


def _distribute(x: torch.Tensor, mesh: DeviceMesh, placements) -> DTensor:
    """Each rank's shard of `x` (which every rank holds whole) as a DTensor,
    cut locally, with no collective (`distribute_tensor` scatters from one
    rank). The placements come from `spec_for`, which shards evenly only."""
    local, cut = x, False
    for i, pl in enumerate(placements):  # nested in the mesh's order, as DTensor's
        if isinstance(pl, Shard) and mesh.size(i) > 1:
            local = local.tensor_split(mesh.size(i), dim=pl.dim)[mesh.get_local_rank(i)]
            cut = True
    # a cut shard gets storage of its own: a view would keep the whole tensor
    # alive on every rank
    local = local.clone(memory_format=torch.contiguous_format) if cut else local.contiguous()
    # the global shape and strides given: DTensor infers the strides from the
    # local ones, which a shard of size 1 leaves ambiguous (a (64, 1, 64) shard
    # of (1024, 16, 64) read as strides (64, 1024, 1), which no view takes)
    stride = [1] * x.dim()
    for i in range(x.dim() - 2, -1, -1):
        stride[i] = stride[i + 1] * x.shape[i + 1]
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=x.shape, stride=tuple(stride))


def replicated_like(ref: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """`t` (a plain tensor, the same on every rank) replicated on `ref`'s
    mesh when `ref` is a DTensor; `t` itself otherwise."""
    if not isinstance(ref, DTensor):
        return t
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole value as a plain tensor, the same on every rank (a
    partial sum reduced, shards gathered); a plain tensor itself."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def placements_of(shape: Sequence[int], axes: Sequence[Optional[str]]) -> List[Placement]:
    """The placements `axes` resolve to for `shape` on the active mesh."""
    ctx = _ctx.get()
    if ctx is None:
        raise RuntimeError("placements_of needs an active mesh (use_mesh)")
    return list(placements_for(spec_for(shape, axes), ctx.mesh))


def dims_sharding(placements: Sequence[Placement], dim: int) -> List[int]:
    """The mesh dims on which `placements` shard tensor dim `dim`."""
    return [i for i, p in enumerate(placements) if isinstance(p, Shard) and p.dim == dim]


def shard_index(mesh: DeviceMesh, dims: Sequence[int]) -> int:
    """This rank's shard of a tensor dim split over mesh `dims` (in the
    mesh's order, nested as DTensor nests them)."""
    idx = 0
    for i in dims:
        idx = idx * mesh.size(i) + mesh.get_local_rank(i)
    return idx


def shard_start(mesh: DeviceMesh, dims: Sequence[int], local_size: int) -> int:
    """This rank's first index along a tensor dim split evenly over mesh
    `dims` into shards of `local_size` (0 with no dims): the global
    position of local row 0."""
    return shard_index(mesh, dims) * local_size


def placed(dims: Dict[int, Sequence[int]]) -> List[Placement]:
    """Placements on the active mesh that shard tensor dim d over the mesh
    dims `dims[d]` and replicate over every other mesh dim."""
    out: List[Placement] = [Replicate()] * current_mesh().ndim
    for d, mesh_dims in dims.items():
        for i in mesh_dims:
            out[i] = Shard(d)
    return out


def redistribute(x: DTensor, placements: Sequence[Placement]) -> DTensor:
    """`x` redistributed to `placements`: DTensor's own path (a partial sum
    to a shard is a reduce-scatter, a shard of one dim to another an
    all-to-all), except on gloo, which has neither (`_whole_then_cut`). `x`
    itself when it is already so placed."""
    want = tuple(placements)
    if tuple(x.placements) == want:
        return x
    if dist.get_backend(x.device_mesh.get_group(0)) != "gloo":
        return x.redistribute(x.device_mesh, want)
    return _whole_then_cut(x, want)


def _whole_then_cut(x: DTensor, want: Tuple[Placement, ...]) -> DTensor:
    """`redistribute` through the collectives gloo has: a partial sum or a
    shard that must become a shard of another dim is first made whole
    (all-reduce, all-gather), then cut locally."""
    whole = tuple(Replicate() if p != w and (isinstance(p, Partial) or
                                             isinstance(p, Shard) and isinstance(w, Shard))
                  else p for p, w in zip(x.placements, want))
    if whole != tuple(x.placements):
        x = x.redistribute(x.device_mesh, whole)
    return x if whole == want else x.redistribute(x.device_mesh, want)


def run_local(fn, out_placements, in_placements, *args, inplace: Sequence[int] = ()):
    """`fn` on each rank's local shards (`local_map`): each DTensor argument
    is redistributed to its entry of `in_placements` first (None for an
    argument that is not a tensor); the result is a DTensor placed as
    `out_placements` says (one list of placements; a tuple of lists for a
    tuple of results).

    `inplace` lists the positions of the arguments `fn` updates in place (a
    recurrent state, a cache leaf or a view of one). Such an argument
    already placed as `fn` takes it reaches `fn` as its own local storage,
    so the update lands in the DTensor; one placed otherwise reaches it as
    a redistributed copy, which is written back into it after the call.

    Gradients: `local_map` labels each local input's gradient with the
    input's own placements unless told otherwise. An input that enters
    replicated on a mesh dim where another DTensor argument is sharded (or
    a partial sum) is used by each rank with its own part of that argument
    only, so each rank's gradient there is a part of the whole: it is
    declared Partial() on that dim (`_grad_placements`). A gradient
    labelled Replicate there would be one rank's part taken for the sum."""
    from torch.distributed.tensor.experimental import local_map

    in_pl = tuple(None if p is None else tuple(p) for p in in_placements)
    args = list(args)
    back = []
    for i, a in enumerate(args):
        if isinstance(a, DTensor):
            moved = redistribute(a, in_pl[i])
            if i in inplace and moved is not a:
                back.append((a, moved))
            args[i] = moved
    out = local_map(fn, out_placements=out_placements, in_placements=in_pl,
                    in_grad_placements=_grad_placements(in_pl, args), device_mesh=current_mesh(),
                    redistribute_inputs=False)(*args)
    for dst, moved in back:
        dst.copy_(redistribute(moved, dst.placements))
    return out


def _grad_placements(in_pl, args) -> Tuple:
    """`run_local`'s gradient placements: each DTensor argument's own
    placements with Partial() on every mesh dim where it is replicated and
    another DTensor argument is not (a partial sum's gradient is Replicate,
    as DTensor normalises it); None for the other arguments."""
    dt = [i for i, a in enumerate(args) if isinstance(a, DTensor)]
    out = []
    for i, pl in enumerate(in_pl):
        if i not in dt:
            out.append(None)
            continue
        others = [in_pl[j] for j in dt if j != i]
        out.append(tuple(
            Partial() if isinstance(p, Replicate) and any(not isinstance(o[m], Replicate)
                                                          for o in others)
            else Replicate() if isinstance(p, Partial) else p
            for m, p in enumerate(pl)))
    return tuple(out)


def write_slots(dst: DTensor, src: DTensor, pos: DTensor) -> None:
    """In place, dst[b, pos[b] % Sc] = src[b] for a DTensor dst (B, Sc, ...)
    as it is laid out (batch, slots and any later dim sharded or not): each
    rank writes the rows it holds into the slots it holds, mapping the
    global slot to its local one. The sharded counterpart of a flat
    `index_copy_`, which a sharded batch x slots cannot take as a view.
    `dst` may be one layer of a stacked cache (`cache["k"][i]`, (L, B, Sc,
    ...); zamba2's shared-block and enc-dec's self caches alike): the
    layer's DTensor is a view of the stack's local storage, which the
    write reaches unmoved (`dst` keeps its placements)."""
    pl = list(dst.placements)
    if any(not isinstance(p, (Shard, Replicate)) for p in pl):
        raise ValueError(f"write_slots: dst placements {pl}")
    src_pl = [Replicate() if not isinstance(p, Shard) or p.dim == 1
              else Shard(p.dim - 1 if p.dim > 1 else 0) for p in pl]
    pos_pl = [Shard(0) if isinstance(p, Shard) and p.dim == 0 else Replicate() for p in pl]
    Sc, mesh, seq_dims = dst.shape[1], dst.device_mesh, dims_sharding(pl, 1)

    def write(d, s, q):
        n = d.shape[1]
        slot = (q % Sc).long() - shard_index(mesh, seq_dims) * n
        own = ((slot >= 0) & (slot < n)).view(-1, *[1] * (s.dim() - 1))
        b, ls = torch.arange(d.shape[0], device=d.device), slot.clamp(0, n - 1)
        d[b, ls] = torch.where(own, s.to(d.dtype), d[b, ls])  # others write back their own
        return d

    run_local(write, pl, (pl, src_pl, pos_pl), dst, src, pos, inplace=(0,))


def _tree_map(fn, tree, axes):
    if isinstance(tree, nn.Module):  # parameters, keyed by name
        tree = dict(tree.named_parameters())
    if isinstance(axes, Axes):
        return fn(tree, axes)
    if isinstance(tree, dict):
        if set(tree) != set(axes):
            raise KeyError(f"tree keys {sorted(tree)} != axes keys {sorted(axes)}")
        return {k: _tree_map(fn, tree[k], axes[k]) for k in tree}
    if isinstance(tree, (list, tuple)):
        if len(tree) != len(axes):
            raise ValueError(f"{len(tree)} leaves against {len(axes)} axes")
        return type(tree)(_tree_map(fn, t, a) for t, a in zip(tree, axes))
    raise TypeError(f"axes {axes!r} against a {type(tree).__name__}")


def tree_specs(arrays_tree, axes_tree):
    """Map (tensors, logical-axes) trees -> a PartitionSpec tree. Trees are
    name-keyed dicts, lists or tuples (a module stands for its parameters,
    keyed by name); tensor leaves need only `.shape` (meta tensors will
    do), axes leaves are `Axes`."""
    return _tree_map(lambda arr, ax: spec_for(arr.shape, ax), arrays_tree, axes_tree)


def local_bytes(arrays_tree, axes_tree) -> int:
    """One device's bytes of a tree (`tree_specs`'s trees) laid out by its
    axes on the active mesh: each leaf's local shard, summed."""
    sizes = _ctx.get().sizes
    total = []
    _tree_map(lambda t, ax: total.append(
        local_numel(t.shape, spec_for(t.shape, ax), sizes) * t.element_size()),
        arrays_tree, axes_tree)
    return sum(total)


def local_numel(shape: Sequence[int], spec: Sequence, sizes: Dict[str, int]) -> int:
    """Elements of one device's shard of `shape` under `spec` (every sharded
    dim divides evenly: `spec_for` shards only such dims)."""
    n = 1
    for i, d in enumerate(shape):
        k = 1
        if i < len(spec):
            for ax in _entry_axes(spec[i]):
                k *= sizes[ax]
        n *= d // k
    return n


def distribute_params(params: nn.Module, axes: Dict[str, Axes]) -> nn.Module:
    """A copy of `params` whose parameters are DTensors on the active mesh,
    each placed by its axes (`Model.param_axes`) and requiring grad as its
    source does; the module tree is copied, the parameters' storage is not
    where a shard is the whole tensor. The counterpart of the reference's
    params `in_shardings`."""
    ctx = _ctx.get()
    if ctx is None:
        raise RuntimeError("distribute_params needs an active mesh (use_mesh)")
    memo: Dict[int, Any] = {}
    for name, p in params.named_parameters():
        memo[id(p)] = nn.Parameter(on_mesh(p.detach(), axes[name]), requires_grad=p.requires_grad)
        memo[id(p)].axes = axes[name]
    return copy.deepcopy(params, memo)


def distribute_tree(tree, axes):
    """A tree of tensors (a cache, optimizer moments, a batch; one tensor
    against one `Axes`) on the active mesh, each leaf placed by its axes
    (`on_mesh`)."""
    if _ctx.get() is None:
        raise RuntimeError("distribute_tree needs an active mesh (use_mesh)")
    return _tree_map(on_mesh, tree, axes)
