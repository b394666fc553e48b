"""Sharded serving of every family but dense on two CPU ranks, against the
unsharded port and the JAX reference.

One `torch.multiprocessing` spawn of two gloo ranks (a `FileStore` under
the test's tmp dir, a 60 s process-group timeout, a LIMIT_S limit of its
own) runs each case's smoke config (f32, `dataclasses.replace`d so that it
holds a block of every kind its family has) under `sharding.use_mesh`:
prefill under PREFILL_RULES, then greedy decode steps under DECODE_RULES.
`attention_impl="pallas"` takes the kernels' wrappers, which run the plain
versions on the local shards through `local_map`, as the card runs the
kernels:

  * moe: mixtral-8x22b (top-2, sliding window) on (1, 2) and (2, 1), and
    under einsum dispatch on (1, 2), llama4-scout-17b-a16e (top-1, iRoPE)
    on (1, 2): routing, dispatch and combine on each rank's batch rows, the
    expert products on ffn shards;
  * vlm: qwen2-vl-72b on (1, 2) with M-RoPE streams that are not text's;
  * hybrid: zamba2-7b with a Mamba2 group, the shared block and a
    remainder layer on (1, 2) and (2, 1), and with 3 Mamba2 heads on (1, 2):
    "model" divides the inner width but not the heads, so the rules
    replicate the heads and the state's conv context is written back;
  * ssm: xlstm-1.3b (an mLSTM group and an sLSTM block) on (1, 2): C
    sharded on its value dim, n on its key dim;
  * enc-dec: seamless-m4t-large-v2 on (1, 2) and (2, 1), encoder frames
    from the seed: the non-causal encoder, cross prefill and cross decode;
    and on (1, 2) with 16 frames, which "model" divides, so that the cross
    cache too is cut by slots.

Decode over a cache whose slots are sharded runs the kernel on each rank's
own slots and merges the ranks' parts (`kernels/ops.py`): rank 0 logs every
collective of the decode steps (`CollectiveLog`), and none moves a tensor
of a cache's shape.

The same weights (the reference's init with every constant leaf, norms and
biases, perturbed from a seed; converted) run unsharded in the port and in
JAX in this process: logits agree within TOL (tests/test_consistency.py),
greedy tokens are identical, no router pick of the moe cases sits on a
tie, and the hybrid and ssm decode steps update every recurrent state leaf
of the sharded cache in place.
"""

import contextlib
import dataclasses
import datetime
import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import RuntimeFlags as JaxFlags  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import transformer as jax_transformer  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import convert_params  # noqa: E402
from repro_torch.models import RuntimeFlags, build_model  # noqa: E402
from test_torch_sharded_serving import CollectiveLog, cache_moved  # noqa: E402

TOL = 2e-3
B, S, STEPS = 2, 12, 4
LIMIT_S = 200  # the spawn's own time limit
TIE = 1e-4  # the least gap between a token's k-th and (k+1)-th router probability
# (case name, arch, config fields replaced, mesh shape)
CASES = [
    ("mixtral-8x22b (1, 2)", "mixtral-8x22b", {}, (1, 2)),
    ("mixtral-8x22b (2, 1)", "mixtral-8x22b", {}, (2, 1)),
    ("mixtral-8x22b einsum dispatch (1, 2)", "mixtral-8x22b", {"moe_dispatch": "einsum"}, (1, 2)),
    ("llama4-scout-17b-a16e (1, 2)", "llama4-scout-17b-a16e", {}, (1, 2)),
    ("qwen2-vl-72b (1, 2)", "qwen2-vl-72b", {}, (1, 2)),
    ("zamba2-7b (1, 2)", "zamba2-7b", {"n_layers": 3}, (1, 2)),
    ("zamba2-7b (2, 1)", "zamba2-7b", {"n_layers": 3}, (2, 1)),
    ("zamba2-7b 3 heads (1, 2)", "zamba2-7b",
     {"n_layers": 3, "d_model": 192, "ssm_head_dim": 128}, (1, 2)),
    ("xlstm-1.3b (1, 2)", "xlstm-1.3b", {}, (1, 2)),
    ("seamless-m4t-large-v2 (1, 2)", "seamless-m4t-large-v2", {}, (1, 2)),
    ("seamless-m4t-large-v2 (2, 1)", "seamless-m4t-large-v2", {}, (2, 1)),
    ("seamless-m4t-large-v2 16 frames (1, 2)", "seamless-m4t-large-v2", {"enc_frames": S + 4},
     (1, 2)),
]
FLAGS = ("moe_dispatch", "enc_frames")  # case fields that are not config fields


def _cfg(get, arch, fields):
    fields = {k: v for k, v in fields.items() if k not in FLAGS}
    return dataclasses.replace(get(arch, smoke=True), dtype="float32", **fields)


def _flags(fields):
    """The port's flags: the kernels' wrappers, and the case's moe dispatch."""
    return RuntimeFlags(attention_impl="pallas",
                        moe_dispatch=fields.get("moe_dispatch", "scatter"))


def _key(arch, fields):
    return arch + "".join(f"-{k}{v}" for k, v in sorted(fields.items()))


def _frames(fields):
    """The enc-dec case's encoder frames."""
    return fields.get("enc_frames", S + 3)


def _inputs(cfg, fields):
    """The prompt (tokens, vlm embeds or enc-dec's dict), its M-RoPE streams
    (vlm; None otherwise), as numpy, from seed 0."""
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 1000, (B, S), np.int32)
    if cfg.n_encoder_layers:
        enc = (0.5 * rng.standard_normal((B, _frames(fields), cfg.d_model))).astype(np.float32)
        return {"enc_embeds": enc, "dec_tokens": tokens}, None
    if cfg.embeds_input:
        embeds = (0.5 * rng.standard_normal((B, S, cfg.d_model))).astype(np.float32)
        t = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
        m = np.stack([t, t // 3, (t % 3) + 2 * np.arange(B, dtype=np.int32)[:, None]])
        return embeds, m.astype(np.int32)
    return tokens, None


def _leaves(tree):
    """A cache (or axes) tree's leaves in key order."""
    return [x for k in sorted(tree) for x in
            (_leaves(tree[k]) if isinstance(tree[k], dict) else [tree[k]])]


def _tree(fn, tree):
    return {k: _tree(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _pad(cache, n):
    """The cache with n empty slots after the prompt's in its self-attention
    leaves; the cross and recurrent leaves as they are."""
    out = dict(cache)
    for k in ("k", "v"):
        if k in cache:
            out[k] = torch.nn.functional.pad(cache[k], (0, 0, 0, 0, 0, n))
    if "pos" in cache:
        out["pos"] = torch.nn.functional.pad(cache["pos"], (0, n), value=-1)
    return out


RECURRENT = ("mamba", "rest", "mlstm", "slstm")  # the cache's recurrent state trees


def _greedy(model, params, prompt, mrope, steps, on_mesh=None, in_place=None,
            log=contextlib.nullcontext()):
    """Prefill, then `steps` greedy decode steps (inside `log`) -> (the
    logits of every step, prefill's first, as one (steps + 1, B, V) array;
    the tokens fed). Under a mesh, from the second step on (the cache is
    laid out by then), `in_place` gets one flag a recurrent state leaf and
    step: the step returned the same DTensor and changed its local
    storage."""
    from repro_torch import sharding as sh

    full = (lambda t: t.full_tensor()) if on_mesh else (lambda t: t)
    ctx = (lambda r: sh.use_mesh(on_mesh, r)) if on_mesh else (lambda r: contextlib.nullcontext())
    with torch.no_grad():
        with ctx(sh.PREFILL_RULES):
            if on_mesh:
                params = model.distribute_params(params)
            logits, cache = model.prefill(params, prompt, mrope_positions=mrope)
        cache = _pad(_tree(full, cache), steps)
        out, toks = [full(logits)], []
        with ctx(sh.DECODE_RULES), log:
            for i in range(steps):
                tok = out[-1].argmax(-1).to(torch.int32)
                toks.append(tok)
                pos = torch.full((B,), S + i, dtype=torch.int32)
                states = [(k, n, leaf, leaf.to_local().clone())
                          for k in RECURRENT if on_mesh and i and k in cache
                          for n, leaf in cache[k].items()]
                logits, cache = model.decode(params, cache, tok, pos)
                out.append(full(logits))
                for k, n, leaf, before in states:
                    in_place.append(cache[k][n] is leaf
                                    and not torch.equal(before, leaf.to_local()))
    return torch.stack(out).numpy(), torch.stack(toks).numpy()


def _torch_inputs(prompt, mrope):
    if isinstance(prompt, dict):
        prompt = {k: torch.from_numpy(v) for k, v in prompt.items()}
    else:
        prompt = torch.from_numpy(prompt)
    return prompt, None if mrope is None else torch.from_numpy(mrope)


def _port(cfg, fields, tmp, key):
    model = build_model(cfg, _flags(fields))
    params = convert_params(_unflatten(np.load(os.path.join(tmp, key + ".npz"))), cfg,
                            device="cpu")
    return model, params


def _rank(rank, store, tmp, cases):
    """One gloo rank: every case under its mesh, then a zeroed cache under
    DECODE_RULES; each rank saves its logits, tokens, in-place flags and
    whether each `init_cache` leaf is placed by its axes."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch import sharding as sh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=60))
    try:
        for name, arch, fields, shape in cases:
            cfg = _cfg(get_config, arch, fields)
            model, params = _port(cfg, fields, tmp, _key(arch, fields))
            prompt, mrope = _torch_inputs(*_inputs(cfg, fields))
            mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
            in_place, log = [], CollectiveLog()
            logits, toks = _greedy(model, params, prompt, mrope, STEPS, on_mesh=mesh,
                                   in_place=in_place, log=log)
            with sh.use_mesh(mesh, sh.DECODE_RULES):  # a zeroed cache, on the mesh by its axes
                cache = model.init_cache(B, S + STEPS, device="cpu", enc_len=_frames(fields))
                placed = [isinstance(t, DTensor) and list(t.placements) == sh.placements_of(
                    t.shape, ax) for t, ax in zip(_leaves(cache), _leaves(model.cache_axes()))]
            np.savez(os.path.join(tmp, f"out-{name}-{rank}.npz"), logits=logits, toks=toks,
                     in_place=np.array(in_place, bool), init_cache=np.array(placed, bool))
            if rank == 0:
                with open(os.path.join(tmp, f"log-{name}.json"), "w") as f:
                    json.dump({"seen": log.seen, "calls": log.calls}, f)
    finally:
        dist.destroy_process_group()


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _unflatten(flat):
    tree = {}
    for name in flat.files:
        node = tree
        *path, leaf = name.split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = flat[name]
    return tree


def _perturbed(flat, seed):
    """Every constant leaf (norm gammas, biases, D, A_log, dt_bias, skip)
    plus 0.1 N(0, 1) from `seed`, so that a gamma or bias cut on the wrong
    shard shows; the xLSTM gate biases plus N(0, 1), so that the mLSTM's
    input gates open far enough for n . q to decide some heads'
    denominators (at the init's zero gate bias exp(-m) decides every one,
    and a wrong n . q would not show). A_log stays near 0: larger decays
    overflow the reference's Mamba2 scan to NaN (ROADMAP.md, section 3)."""
    rng = np.random.default_rng(seed)
    return {k: (v + (1.0 if k.endswith(("b_if", "b_gates")) else 0.1)
                * rng.standard_normal(v.shape)).astype(v.dtype)
            if v.size > 1 and np.all(v == v.flat[0]) else v for k, v in flat.items()}


def _jax_logits(mj, pj, cfg_j, prompt, mrope, toks):
    """The reference's prefill, then its decode steps fed `toks`."""
    if isinstance(prompt, dict):
        l0, cache = mj.prefill(pj, {k: jnp.asarray(v) for k, v in prompt.items()})
    else:
        l0, cache = jax_transformer.decoder_prefill(
            pj, cfg_j, mj.rt, jnp.asarray(prompt),
            mrope_positions=None if mrope is None else jnp.asarray(mrope))
    cache = dict(cache)
    for k in ("k", "v"):
        if k in cache:
            cache[k] = jnp.pad(cache[k], ((0, 0), (0, 0), (0, len(toks)), (0, 0), (0, 0)))
    if "pos" in cache:
        cache["pos"] = jnp.pad(cache["pos"], ((0, 0), (0, len(toks))), constant_values=-1)
    out = [np.asarray(l0)]
    for i, tok in enumerate(toks):
        pos = jnp.full((B,), S + i, jnp.int32)
        lj, cache = mj.decode(pj, cache, jnp.asarray(tok), pos)
        out.append(np.asarray(lj))
    return np.stack(out)


@contextlib.contextmanager
def _router_gaps(gaps):
    """Append, for every moe routing call while inside, the least gap
    between a token's k-th and (k+1)-th router probability."""
    from repro_torch.models import moe

    route = moe._route

    def recording(p, x, cfg, C):
        out = route(p, x, cfg, C)
        top = torch.sort(out[6], dim=-1, descending=True).values
        gaps.append(float((top[..., cfg.top_k - 1] - top[..., cfg.top_k]).min()))
        return out

    moe._route = recording
    try:
        yield gaps
    finally:
        moe._route = route


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """Weights, then the two ranks' run of every case, while the unsharded
    port and JAX run here: {case: (sharded logits and tokens, the port's,
    JAX's logits, router gaps, each rank's init_cache flags, each rank's
    in-place flags)}."""
    tmp = str(tmp_path_factory.mktemp("sharded_families"))
    refs, jax_models = {}, {}
    for _, arch, fields, _ in CASES:
        key = _key(arch, fields)
        if key not in jax_models:
            cfg_j = _cfg(jax_get_config, arch, fields)
            mj = jax_build_model(cfg_j, JaxFlags(
                remat=False, moe_dispatch=fields.get("moe_dispatch", "scatter")))
            pj, _ = mj.init(jax.random.PRNGKey(0))
            flat = _perturbed(_flatten(jax.tree.map(np.asarray, pj)), seed=len(jax_models))
            np.savez(os.path.join(tmp, key + ".npz"), **flat)
            jax_models[key] = (mj, cfg_j, jax.tree.map(jnp.asarray, _unflatten(
                np.load(os.path.join(tmp, key + ".npz")))))
    t0 = time.time()
    ctx = mp.start_processes(_rank, args=(os.path.join(tmp, "store"), tmp, CASES), nprocs=2,
                             join=False, start_method="spawn")
    try:
        for _, arch, fields, _ in CASES:  # the references, while the ranks run
            key = _key(arch, fields)
            if key in refs:
                continue
            cfg = _cfg(get_config, arch, fields)
            inputs = _inputs(cfg, fields)
            model, params = _port(cfg, fields, tmp, key)
            with _router_gaps([]) as gaps:
                logits, toks = _greedy(model, params, *_torch_inputs(*inputs), STEPS)
            mj, cfg_j, pj = jax_models[key]
            refs[key] = (logits, toks, _jax_logits(mj, pj, cfg_j, *inputs, toks), gaps)
    finally:
        while not ctx.join(timeout=max(1.0, LIMIT_S - (time.time() - t0))):
            if time.time() - t0 > LIMIT_S:
                for p in ctx.processes:
                    p.terminate()
                pytest.fail(f"the two ranks did not finish within {LIMIT_S} s")
    out = {}
    for name, arch, fields, _ in CASES:
        got = [np.load(os.path.join(tmp, f"out-{name}-{r}.npz")) for r in range(2)]
        with open(os.path.join(tmp, f"log-{name}.json")) as f:
            log = json.load(f)
        out[name] = (got[0]["logits"], got[0]["toks"], *refs[_key(arch, fields)],
                     [g["init_cache"] for g in got], [g["in_place"] for g in got], log)
    return out


@pytest.mark.parametrize("case", [c[0] for c in CASES])
class TestShardedFamilies:
    def test_logits_match_unsharded_port(self, sharded, case):
        logits, _, ref_logits, *_ = sharded[case]
        np.testing.assert_allclose(logits, ref_logits, rtol=TOL, atol=TOL)

    def test_logits_match_jax(self, sharded, case):
        logits, _, _, _, jax_logits, *_ = sharded[case]
        np.testing.assert_allclose(logits, jax_logits, rtol=TOL, atol=TOL)

    def test_init_cache_on_mesh(self, sharded, case):
        """Under a mesh `Model.init_cache` lays every leaf, the recurrent and
        cross ones too, out by `cache_axes` on both ranks."""
        flags = sharded[case][6]
        assert all(f.size and f.all() for f in flags), flags

    def test_greedy_tokens_identical(self, sharded, case):
        _, toks, _, ref_toks, *_ = sharded[case]
        np.testing.assert_array_equal(toks, ref_toks)

    def test_decode_keeps_the_cache_in_place(self, sharded, case):
        """Each decode call over a cache whose slots "model" divides (the
        self cache's S + STEPS; the cross cache's frames where they divide)
        takes the merge path, the others do not; no collective of the decode
        steps moves K, V or positions of a cache's shape."""
        _, arch, fields, shape = next(c for c in CASES if c[0] == case)
        cfg, log = _cfg(get_config, arch, fields), sharded[case][8]
        if cfg.family == "ssm":  # no attention
            assert not log["calls"]
            return
        assert all(slots == merged for slots, merged in log["calls"]), log["calls"]
        cuts = [S + STEPS] + ([_frames(fields)] if cfg.n_encoder_layers else [])
        sharded_slots = [n for n in cuts if n % shape[1] == 0]
        assert sum(merged for _, merged in log["calls"]) == (
            len(log["calls"]) * len(sharded_slots) // len(cuts)) > 0, log["calls"]
        slots = {n // d for n in cuts for d in (1, shape[1])}
        assert not cache_moved(log["seen"], slots, cfg.head_dim), log["seen"]


@pytest.mark.parametrize("case", [c[0] for c in CASES if c[1] in ("mixtral-8x22b",
                                                                  "llama4-scout-17b-a16e")])
def test_no_router_pick_on_a_tie(sharded, case):
    """Every routing call of the unsharded run (prefill and each decode step,
    every layer) keeps a gap of at least TIE between its last pick and the
    next expert, so rounding cannot flip a pick between the runs."""
    gaps = sharded[case][5]
    assert gaps and min(gaps) > TIE, min(gaps)


@pytest.mark.parametrize("case", [c[0] for c in CASES if c[1] in ("zamba2-7b", "xlstm-1.3b")])
def test_recurrent_state_updated_in_place(sharded, case):
    """Each decode step updates every recurrent state leaf of the sharded
    cache in place on both ranks: the step returns the same DTensor, whose
    local storage (reached through a per-layer view of the stacked leaf)
    changed; no update went to a temporary."""
    flags = sharded[case][7]
    assert all(f.size and f.all() for f in flags), flags
