"""The cost of one step, counted on the meta device (the port's counterpart
of `repro/launch/hlo_analysis.py`, which reads the same quantities out of
compiled HLO text).

`analyze_case(case)` runs a `specs.Case`'s step once on meta tensors under
a dispatch mode: nothing is computed and nothing is allocated. It counts

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
same way); rmsnorm counts as `kernels.ref.rmsnorm`, and decode attention as
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
from typing import Any, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

__all__ = ["PARTS", "StepCost", "analyze_case", "analyze_step"]

PARTS = ("params", "grads", "moments", "cache", "inputs", "other")

aten = torch.ops.aten
# (op, positions of its two matrix operands)
DOT_OPS = {aten.mm.default: (0, 1), aten.bmm.default: (0, 1),
           aten.addmm.default: (1, 2), aten.baddbmm.default: (1, 2)}


@dataclasses.dataclass
class StepCost:
    flops: float  # dot FLOPs of the step
    dot_bytes: float  # operand + result bytes of every dot
    peak_bytes: int  # live tensor bytes at the step's peak
    parts: Dict[str, int]  # peak_bytes by PARTS
    n_ops: int  # ops dispatched
    collective_bytes: float = 0.0  # one card: no collectives


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

    def track(self, t: torch.Tensor, part: str = "other") -> None:
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
        fresh = not s.is_mutable and all(r.alias_info is None for r in s.returns)
        info = self.info[func] = (fresh, flop_registry.get(func._overloadpacket))
        return info

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n_ops += 1
        fresh, formula = self.info.get(func) or self._op_info(func)
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
            if t.device.type != "meta":
                raise ValueError(f"{part}: a {t.device.type} tensor; the dry run "
                                 "runs on the meta device only")
            tracker.track(t, part)
    grads = _gradients_marked(tracker) if train else contextlib.nullcontext()
    with grads, tracker:
        out = step(*args)
    del out
    peak, by_part = tracker.peak()
    return StepCost(flops=float(tracker.flops), dot_bytes=float(tracker.dot_bytes),
                    peak_bytes=peak, parts=by_part, n_ops=tracker.n_ops)


def analyze_case(case, memo: bool = True) -> StepCost:
    """`analyze_step` of a `specs.Case`, its arguments split into parts by
    the step's kind."""
    if case.shape.kind == "train":
        params, state, batch = case.args
        parts = {"params": params, "moments": state, "inputs": batch}
    elif case.shape.kind == "prefill":
        params, prompt = case.args
        parts = {"params": params, "inputs": prompt}
    else:
        params, cache, token, pos = case.args
        parts = {"params": params, "cache": cache, "inputs": (token, pos)}
    return analyze_step(case.step, case.args, parts, train=case.shape.kind == "train",
                        memo=memo)
