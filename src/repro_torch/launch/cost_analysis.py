"""The cost of one step, counted on the meta device (the port's counterpart
of `repro/launch/hlo_analysis.py`, which reads the same quantities out of
compiled HLO text).

`analyze_case(case)` runs a `specs.Case`'s step once on meta tensors under
a dispatch mode: nothing is computed and nothing is allocated. On a mesh
(`analyze_step` of DTensor arguments, inside `launch.mesh.fake_process_group`
and `sharding.use_mesh`) every quantity is one device's, as the reference's
per-program count is: the mode hands every op on a DTensor back to DTensor
(`NotImplemented`), which desugars it into the local op on this rank's
shards and the collectives of any redistribution, and counts those; the
ops that DTensor's sharding propagation runs on FakeTensors at global
shapes are not counted. It counts

  * dot FLOPs: every matmul-class op (mm, addmm, bmm, baddbmm), counted by
    the formulas of `torch.utils.flop_counter` (`FlopCounterMode`'s, and
    equal to its count), elementwise work excluded: the MFU convention of
    the reference's count;
  * dot traffic: operand plus result bytes of each such op, as the
    reference counts a dot's (an upper bound on the compute stream's HBM
    traffic: reuse between ops is not modelled);
  * the peak of live tensor bytes over the step, with its parts at the
    peak: parameters, gradients, optimizer moments, cache, inputs and the
    rest (activations and temporaries). Every storage an op returns is
    tracked until it is freed (`weakref.finalize`); the arguments' storages
    count from the start. This is what the card's caching allocator reports
    as `max_memory_allocated`, less its rounding and workspaces.

What it cannot see: work inside a raw CUDA launch. On the meta device a
tensor is not on the card, so `RuntimeFlags.attn_impl_for` takes the CPU
rule: attention counts as naive up to `naive_below` keys and chunked above
it, never as the flash kernel (whose products the counter could not see
anyway; the reference's HLO count is blind to its Pallas custom calls in the
same way), under context parallelism on each rank's block of query rows
against the whole sequence's keys, as the reference's partitioned score
chain: neither side skips the causal triangle's masked half; rmsnorm counts
as `kernels.ref.rmsnorm`, and decode attention as
`kernels.ref.decode_attention`, whose f32 copy of the cache inflates a
decode step's transient bytes above the kernel's.

Speed: meta tensors run most elementwise ops through Python reference
implementations (~0.1 ms an op). Ops that return fresh tensors are
memoised on their arguments' shapes, strides and dtypes, and repeats return
`torch.empty_strided` of the remembered result: the attention chunk loops
and the sLSTM's time loop repeat the same few ops thousands of times. Views
and in-place ops always run.
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed._functional_collectives import AsyncCollectiveTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

__all__ = ["COLLECTIVES", "PARTS", "StepCost", "analyze_case", "analyze_step"]

PARTS = ("params", "grads", "moments", "cache", "inputs", "other")
# the reference's classes (`repro/launch/hlo_analysis.py`), in its order (DTensor
# emits no collective-permute: that class stays 0)
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")

aten = torch.ops.aten
# (op, positions of its two matrix operands)
DOT_OPS = {aten.mm.default: (0, 1), aten.bmm.default: (0, 1),
           aten.addmm.default: (1, 2), aten.baddbmm.default: (1, 2)}


@dataclasses.dataclass
class StepCost:
    flops: float  # dot FLOPs of the step (one device's)
    dot_bytes: float  # operand + result bytes of every dot
    peak_bytes: int  # live tensor bytes at the step's peak
    parts: Dict[str, int]  # peak_bytes by PARTS
    n_ops: int  # ops dispatched (on plain tensors: one device's)
    # weighted bytes by COLLECTIVES (module docstring); 0 on one card
    collective_bytes: Dict[str, float] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(COLLECTIVES, 0.0))

    @property
    def total_collective_bytes(self) -> float:
        return float(sum(self.collective_bytes.values()))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _key(a):
    """A hashable stand-in for an op's argument: a tensor's metadata, which
    with the other arguments fixes the metadata of a fresh result."""
    if isinstance(a, torch.Tensor):
        return (a.shape, a.stride(), a.dtype, a.device)
    if isinstance(a, (list, tuple)):
        return tuple([_key(x) for x in a])
    if isinstance(a, dict):
        return tuple([(k, _key(v)) for k, v in a.items()])
    if isinstance(a, (bool, int, float)):  # 2 == 2.0 == True, but not as a dtype
        return (a.__class__, a)
    return a


class _Fresh:
    """A memoised result tensor's metadata."""

    __slots__ = ("size", "stride", "dtype", "device")

    def __init__(self, t: torch.Tensor):
        self.size, self.stride, self.dtype, self.device = t.shape, t.stride(), t.dtype, t.device

    def build(self) -> torch.Tensor:
        return torch.empty_strided(self.size, self.stride, dtype=self.dtype, device=self.device)


def _tensors(tree) -> list:
    """Every tensor in a tree of lists, tuples, dicts and modules."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


_RUNS = object()  # memo entry of an op that must run each time

# ops on these tensor types go back to the type's own dispatch, which runs
# the local ops (and collectives) this mode counts
_WRAPPERS = (DTensor, AsyncCollectiveTensor)
# collectives that move nothing of their own
_SYNC = {"wait_tensor", "_wrap_tensor_autograd"}
# (class, its functional op's name with "_" dropped holds, weight, the tensor
# counted: "out" the result, 0 the first argument)
_KINDS = (("all-gather", "allgather", 1, "out"), ("all-reduce", "allreduce", 2, 0),
          ("reduce-scatter", "reducescatter", 1, 0), ("all-to-all", "alltoall", 1, 0))


def _collective(func) -> Optional[Tuple[str, int, Any]]:
    """(class, weight, the tensor counted: "out" or an argument's position)
    of a collective that DTensor emits (its functional collectives and
    `shard_dim_alltoall`), None for any other op. Any other collective
    raises: it would move bytes the count does not read."""
    ns, name = func.namespace, func._schema.name.split("::")[-1]
    if ns == "_dtensor" and name == "shard_dim_alltoall":
        return "all-to-all", 1, 0
    if ns not in ("_c10d_functional", "_c10d_functional_autograd", "c10d") or name in _SYNC:
        return None
    for cls, part, weight, counted in _KINDS:
        if ns != "c10d" and part in name.replace("_", ""):
            return cls, weight, counted
    raise ValueError(f"{func}: a collective outside the reference's classes {COLLECTIVES} "
                     "as DTensor's functional collectives emit them; the count cannot read it")


def _bytes(tree) -> int:
    return sum(_nbytes(t) for t in _tensors(tree))


def _fake_mode_active() -> bool:
    """Whether a FakeTensorMode runs (sharding propagation's shape
    inference: its ops, factories included, are not the step's)."""
    return torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None


class _Tracker(TorchDispatchMode):
    """Dot FLOPs and traffic, live storages and the op memo (module
    docstring). FLOPs come from `torch.utils.flop_counter`'s formulas, the
    ones `FlopCounterMode` applies (one mode instead of two halves the
    per-op cost of the Python dispatch)."""

    def __init__(self, memo: bool = True):
        super().__init__()
        self.memo_on = memo
        self.memo: Dict[Any, Any] = {}
        self.info: Dict[Any, tuple] = {}  # op -> (fresh results only, flop formula)
        self.live: Dict[int, Tuple[int, int]] = {}  # storage address -> (serial, bytes)
        self.events: List[Tuple[int, int]] = []  # (serial, +bytes or -bytes)
        self.part: Dict[int, str] = {}  # serial -> part, for storages not "other"
        self.serial = 0
        self.flops = 0
        self.dot_bytes = 0
        self.n_ops = 0
        self.collective = dict.fromkeys(COLLECTIVES, 0)

    def track(self, t: torch.Tensor, part: str = "other") -> None:
        if isinstance(t, DTensor):  # one device's bytes: its local shard
            t = t._local_tensor
        st = t.untyped_storage()
        key = id(st)  # one Python object a storage while it lives
        entry = self.live.get(key)
        if entry is not None:
            if part != "other":
                self.part[entry[0]] = part
            return
        self.serial += 1
        nb = st.nbytes()
        self.live[key] = (self.serial, nb)
        self.events.append((self.serial, nb))
        if part != "other":
            self.part[self.serial] = part
        weakref.finalize(st, self._free, key, self.serial, nb)

    def _free(self, key: int, serial: int, nb: int) -> None:
        if self.live.get(key, (None,))[0] == serial:
            del self.live[key]
            self.events.append((serial, -nb))

    def _op_info(self, func) -> tuple:
        s = func._schema
        coll = _collective(func)
        # a collective runs each time: its result is the backend's
        fresh = not s.is_mutable and all(r.alias_info is None for r in s.returns) and not coll
        info = self.info[func] = (fresh, flop_registry.get(func._overloadpacket), coll)
        return info

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, _WRAPPERS) for t in types):
            return NotImplemented
        if any(issubclass(t, FakeTensor) for t in types) or _fake_mode_active():
            return func(*args, **(kwargs or {}))
        self.n_ops += 1
        fresh, formula, coll = self.info.get(func) or self._op_info(func)
        key = None
        if fresh and self.memo_on:
            key = (func, _key(args), _key(kwargs) if kwargs else None)
            try:
                entry = self.memo.get(key)
            except TypeError:  # an unhashable argument
                entry = key = _RUNS
            if entry is _RUNS:
                key = None
            elif entry is not None:
                metas, flops, dot_bytes = entry
                self.flops += flops
                self.dot_bytes += dot_bytes
                out = (metas.build() if isinstance(metas, _Fresh)
                       else type(metas)(m.build() if isinstance(m, _Fresh) else m for m in metas))
                for t in _tensors(out):
                    self.track(t)
                return out
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if coll is not None:
            cls, weight, counted = coll
            self.collective[cls] += weight * _bytes(out if counted == "out" else args[counted])
        flops = formula(*args, **kwargs, out_val=out) if formula is not None else 0
        dot = DOT_OPS.get(func)
        dot_bytes = (_nbytes(args[dot[0]]) + _nbytes(args[dot[1]]) + _nbytes(out)
                     if dot is not None else 0)
        self.flops += flops
        self.dot_bytes += dot_bytes
        outs = _tensors(out)
        if key is not None:
            # an op whose schema declares no alias may still return a view of
            # an argument (`_unsafe_view`), and a result may be nested: such
            # ops run each time
            ins = {id(t.untyped_storage()) for t in _tensors((args, kwargs))}
            simple = isinstance(out, torch.Tensor) or (
                isinstance(out, (list, tuple))
                and all(isinstance(t, torch.Tensor) or not isinstance(t, (list, tuple, dict))
                        for t in out))
            if not simple or any(id(t.untyped_storage()) in ins for t in outs):
                self.memo[key] = _RUNS
            else:
                metas = (_Fresh(out) if isinstance(out, torch.Tensor)
                         else type(out)(_Fresh(t) if isinstance(t, torch.Tensor) else t
                                        for t in out))
                self.memo[key] = (metas, flops, dot_bytes)
        for t in outs:
            self.track(t)
        return out

    def peak(self) -> Tuple[int, Dict[str, int]]:
        """(peak live bytes, its parts) from the event log."""
        cur = best = at = 0
        for i, (_, nb) in enumerate(self.events):
            cur += nb
            if cur > best:
                best, at = cur, i
        parts = dict.fromkeys(PARTS, 0)
        for serial, nb in self.events[:at + 1]:
            parts[self.part.get(serial, "other")] += nb
        return best, parts


@contextlib.contextmanager
def _gradients_marked(tracker: _Tracker):
    """While inside, the gradients a train step hands to `adamw_update` are
    marked as the "grads" part (the step takes them by name from
    `torch.autograd.grad`; nothing else tells them from activations)."""
    from ..training import loop

    update = loop.adamw_update

    def marked(cfg, params, grads, state):
        for g in grads.values():
            tracker.track(g, "grads")
        return update(cfg, params, grads, state)

    loop.adamw_update = marked
    try:
        yield
    finally:
        loop.adamw_update = update


def analyze_step(step, args: tuple, parts: Dict[str, Any], train: bool = False,
                 memo: bool = True) -> StepCost:
    """Run `step(*args)` once on meta tensors and count it. `parts` maps a
    part name to the argument trees that hold it (counted from the start);
    with `train`, the gradients passed to `adamw_update` are the "grads"."""
    tracker = _Tracker(memo=memo)
    for part, tree in parts.items():
        for t in _tensors(tree):
            local = t._local_tensor if isinstance(t, DTensor) else t
            if local.device.type != "meta":
                raise ValueError(f"{part}: a {local.device.type} tensor; the dry run "
                                 "runs on the meta device only")
            tracker.track(t, part)
    grads = _gradients_marked(tracker) if train else contextlib.nullcontext()
    with grads, tracker:
        out = step(*args)
    del out
    peak, by_part = tracker.peak()
    return StepCost(flops=float(tracker.flops), dot_bytes=float(tracker.dot_bytes),
                    peak_bytes=peak, parts=by_part, n_ops=tracker.n_ops,
                    collective_bytes={k: float(v) for k, v in tracker.collective.items()})


def analyze_case(case, memo: bool = True, args: Optional[tuple] = None) -> StepCost:
    """`analyze_step` of a `specs.Case`, its arguments (`args`: the case's
    own, or the same laid out on a mesh) counted under `case.arg_parts`."""
    args = case.args if args is None else args
    parts: Dict[str, list] = {}
    for part, arg in zip(case.arg_parts, args):
        parts.setdefault(part, []).append(arg)
    return analyze_step(case.step, args, parts, train=case.shape.kind == "train", memo=memo)
