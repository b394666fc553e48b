"""The port's sharded serving on two CPU ranks against the unsharded port and
the JAX reference.

One `torch.multiprocessing` spawn of two gloo ranks (a `FileStore` under
the test's tmp dir, a 60 s process-group timeout) runs llama2-7b's smoke
config (f32) under `sharding.use_mesh` on a (1, 2) and a (2, 1) mesh, and
glm4-9b's GQA smoke config on (1, 2), as K = 2 and as K = 1: there "model"
divides the query heads but not the KV heads. Prefill runs under
PREFILL_RULES, then greedy decode steps under DECODE_RULES (the cache's
slots sharded over "model"), for llama2-7b on (2, 1) also under
DECODE_RULES_V3 and for glm4-9b on (1, 2) under DECODE_RULES_V2 and V3.
Decode runs the kernel on each rank's own slots and merges the ranks' parts
(`kernels/ops.py`); one more case decodes llama2-7b from an empty cache of
2 x STEPS slots at positions STEPS.., so that every fresh token lies on rank
1 and rank 0's slots are all empty at every step. `attention_impl="pallas"`
takes the kernels' wrappers, which run the plain versions on the local
shards through `local_map`, as the card runs the kernels. The same weights
(the reference's init, converted) run unsharded in the port and in JAX in
this process: logits agree within TOL (tests/test_consistency.py) and
greedy tokens are identical. Two more cases prefill llama2-7b under
TRAIN_RULES_EP_CP with `attn_seq_shard` (context parallelism: each rank's
attention core takes its block of query rows, rank 1's from S / 2), once
through the flash kernel's wrapper and once through the chunked core with
query chunks shorter than a rank's rows; each core call records where its
rows start. Rank 0 logs every collective of the decode
steps (`CollectiveLog`): none moves a tensor of the cache's shape, and every
decode call over a cache whose slots are sharded takes the merge path.

Also the dry run's count of a step on the single production mesh (`--mesh
single`), on the fake backend.
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
from torch.distributed._functional_collectives import AsyncCollectiveTensor  # noqa: E402
from torch.distributed.tensor import DTensor  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import RuntimeFlags as JaxFlags  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import convert_params  # noqa: E402
from repro_torch.models import RuntimeFlags, build_model  # noqa: E402

TOL = 2e-3
B, S, STEPS = 2, 12, 4
LIMIT_S = 150  # the spawn's own time limit (it takes ~15 s on a CPU)
# (case name, arch, kv heads (None: the config's), mesh shape)
CASES = [
    ("llama2-7b (1, 2)", "llama2-7b", None, (1, 2)),
    ("llama2-7b (2, 1)", "llama2-7b", None, (2, 1)),
    ("glm4-9b (1, 2)", "glm4-9b", None, (1, 2)),
    ("glm4-9b K=1 (1, 2)", "glm4-9b", 1, (1, 2)),
    ("llama2-7b DECODE_RULES_V3 (2, 1)", "llama2-7b", None, (2, 1)),
    ("glm4-9b DECODE_RULES_V2 (1, 2)", "glm4-9b", None, (1, 2)),
    ("glm4-9b DECODE_RULES_V3 (1, 2)", "glm4-9b", None, (1, 2)),
    ("llama2-7b fresh token on rank 1 (1, 2)", "llama2-7b", None, (1, 2)),
    ("llama2-7b EP_CP prefill, flash (1, 2)", "llama2-7b", None, (1, 2)),
    ("llama2-7b EP_CP prefill, chunked (1, 2)", "llama2-7b", None, (1, 2)),
]
# context-parallel prefills: the rule set and the RuntimeFlags fields (the
# chunked core's query chunks of 4 below a rank's S / 2 = 6 rows)
CP = {"llama2-7b EP_CP prefill, flash (1, 2)":
      ("TRAIN_RULES_EP_CP", dict(attn_seq_shard=True, attention_impl="pallas")),
      "llama2-7b EP_CP prefill, chunked (1, 2)":
      ("TRAIN_RULES_EP_CP", dict(attn_seq_shard=True, attention_impl="chunked", q_chunk=4,
                                 kv_chunk=4))}
# a case's decode rule set where it is not DECODE_RULES: under V3 the token's
# embed dim is sharded over "data" like the weights' (a projection's partial
# sum over "data", the output projection's result sharded by embed); under V2
# and V3 the token's rows are replicated, the cache's cut by rows
DECODE = {"llama2-7b DECODE_RULES_V3 (2, 1)": "DECODE_RULES_V3",
          "glm4-9b DECODE_RULES_V2 (1, 2)": "DECODE_RULES_V2",
          "glm4-9b DECODE_RULES_V3 (1, 2)": "DECODE_RULES_V3"}
# cases decoded from an empty cache (no prefill): its 2 x STEPS slots are cut
# in two over "model", and the steps' positions STEPS.. land on rank 1's
EMPTY = {"llama2-7b fresh token on rank 1 (1, 2)"}


def _cfg(get, arch, kv):
    cfg = dataclasses.replace(get(arch, smoke=True), dtype="float32")
    return cfg if kv is None else dataclasses.replace(cfg, n_kv_heads=kv)


def _pad(cache, n):
    """The cache with n empty slots after the prompt's."""
    out = {}
    for k in ("k", "v"):
        out[k] = torch.nn.functional.pad(cache[k], (0, 0, 0, 0, 0, n))
    out["pos"] = torch.nn.functional.pad(cache["pos"], (0, n), value=-1)
    return out


def _greedy(model, params, prompt, steps, on_mesh=None, decode="DECODE_RULES", empty=False,
            log=contextlib.nullcontext(), prefill="PREFILL_RULES"):
    """Prefill, then `steps` greedy decode steps (under the rule set named
    `decode`, inside `log`) -> (the logits of every step, prefill's first, as
    one (steps + 1, B, V) array; the tokens fed). With `empty` no prefill:
    the steps start from an empty cache of 2 x `steps` slots at position
    `steps`, the first fed the prompt's first token, and the array holds
    the steps' logits only."""
    from repro_torch import sharding as sh

    full = (lambda t: t.full_tensor()) if on_mesh else (lambda t: t)
    rules = (getattr(sh, prefill), getattr(sh, decode))
    ctx = (lambda r: sh.use_mesh(on_mesh, r)) if on_mesh else (lambda r: contextlib.nullcontext())
    with torch.no_grad():
        with ctx(rules[0]):
            if on_mesh:
                params = model.distribute_params(params)
            if not empty:
                logits, cache = model.prefill(params, prompt)
        if empty:
            cache, out, start = model.init_cache(prompt.shape[0], 2 * steps, device="cpu"), [], steps
        else:
            cache = _pad({k: full(v) for k, v in cache.items()}, steps)
            out, start = [full(logits)], prompt.shape[1]
        toks = []
        with ctx(rules[1]), log:
            for i in range(steps):
                tok = out[-1].argmax(-1).to(torch.int32) if out else prompt[:, 0]
                toks.append(tok)
                pos = torch.full((prompt.shape[0],), start + i, dtype=torch.int32)
                logits, cache = model.decode(params, cache, tok, pos)
                out.append(full(logits))
    return torch.stack(out).numpy(), torch.stack(toks).numpy()


class CollectiveLog(TorchDispatchMode):
    """While inside: every collective that runs (DTensor's redistributions
    and the decode's merge alike), as (its class, the shape and dtype of the
    tensor it moves), classed as `launch.cost_analysis` classes them; and
    the decode calls, each as (its cache's slots sharded, the merge path
    taken)."""

    def __init__(self):
        super().__init__()
        self.seen, self.calls = [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from repro_torch.launch.cost_analysis import _collective

        if any(issubclass(t, (DTensor, AsyncCollectiveTensor)) for t in types):
            return NotImplemented  # DTensor runs it: its local ops come back here
        coll = _collective(func)
        if coll is not None:
            self.seen.append((coll[0], list(args[0].shape), str(args[0].dtype)))
        return func(*args, **(kwargs or {}))

    def __enter__(self):
        from repro_torch import sharding as sh
        from repro_torch.kernels import ops

        self._saved = ops.decode_attention, ops._decode_over_slots
        decode, over_slots = self._saved
        merged = []

        def traced_decode(q, k, *a, **kw):
            merged.clear()
            out = decode(q, k, *a, **kw)
            self.calls.append((bool(sh.dims_sharding(k.placements, 1)), bool(merged)))
            return out

        def traced_over_slots(*a, **kw):
            merged.append(True)
            return over_slots(*a, **kw)

        ops.decode_attention, ops._decode_over_slots = traced_decode, traced_over_slots
        return super().__enter__()

    def __exit__(self, *exc):
        from repro_torch.kernels import ops

        ops.decode_attention, ops._decode_over_slots = self._saved
        return super().__exit__(*exc)


def cache_moved(seen, slots, dh):
    """The logged collectives that move a tensor of the cache's shape: K or
    V rows (..., slots, heads, dh) or slot positions (..., slots) int32, for
    any count of slots in `slots` (a whole cache's or one rank's)."""
    return [c for c in seen if (len(c[1]) >= 3 and c[1][-1] == dh and c[1][-3] in slots)
            or (c[2] == "torch.int32" and len(c[1]) >= 2 and c[1][-1] in slots)]


def _flags(name):
    return RuntimeFlags(**CP[name][1]) if name in CP else RuntimeFlags(attention_impl="pallas")


@contextlib.contextmanager
def _recorded_rows(starts):
    """While inside, each attention core call (the flash kernel's plain
    version, the chunked and naive cores) appends (its first query
    position, its query rows) to `starts`."""
    from repro_torch.kernels import ref
    from repro_torch.models import attention

    saved = ref.flash_attention, attention.naive_attention, attention.chunked_attention

    def flash(q, *a, q_offset=0, **kw):
        starts.append((q_offset, q.shape[1]))
        return saved[0](q, *a, q_offset=q_offset, **kw)

    def wrap(fn):
        def core(q, k, v, q_pos, *rest):
            starts.append((int(q_pos[0, 0]), q.shape[1]))
            return fn(q, k, v, q_pos, *rest)
        return core

    ref.flash_attention = flash
    attention.naive_attention, attention.chunked_attention = map(wrap, saved[1:])
    try:
        yield
    finally:
        ref.flash_attention, attention.naive_attention, attention.chunked_attention = saved


def _rank(rank, store, tmp, cases):
    """One gloo rank: every case under its mesh; rank 0 saves the results,
    each rank where its attention cores' rows started."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=60))
    try:
        for name, arch, kv, shape in cases:
            cfg = _cfg(get_config, arch, kv)
            model = build_model(cfg, _flags(name))
            w = np.load(os.path.join(tmp, f"{arch}-{kv}.npz"))
            params = convert_params(_unflatten(w), cfg, device="cpu")
            prompt = torch.from_numpy(np.load(os.path.join(tmp, "prompt.npy")))
            mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
            log, starts = CollectiveLog(), []
            with _recorded_rows(starts):
                logits, toks = _greedy(model, params, prompt, STEPS, on_mesh=mesh,
                                       decode=DECODE.get(name, "DECODE_RULES"),
                                       empty=name in EMPTY, log=log,
                                       prefill=CP.get(name, ("PREFILL_RULES",))[0])
            np.save(os.path.join(tmp, f"starts-{name}-{rank}.npy"), np.array(starts, int))
            if rank == 0:
                np.savez(os.path.join(tmp, f"out-{name}.npz"), logits=logits, toks=toks)
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


def _jax_logits(mj, pj, prompt, toks, empty=False):
    """The reference's prefill, then its decode steps fed `toks`; with
    `empty`, the steps alone from an empty cache, as `_greedy`'s."""
    if empty:
        cache, out, start = dict(mj.init_cache(prompt.shape[0], 2 * len(toks))[0]), [], len(toks)
    else:
        l0, cache = mj.prefill(pj, jnp.asarray(prompt))
        cache = dict(cache)
        for k in ("k", "v"):
            cache[k] = jnp.pad(cache[k], ((0, 0), (0, 0), (0, len(toks)), (0, 0), (0, 0)))
        cache["pos"] = jnp.pad(cache["pos"], ((0, 0), (0, len(toks))), constant_values=-1)
        out, start = [np.asarray(l0)], prompt.shape[1]
    for i, tok in enumerate(toks):
        pos = jnp.full((prompt.shape[0],), start + i, jnp.int32)
        lj, cache = mj.decode(pj, cache, jnp.asarray(tok), pos)
        out.append(np.asarray(lj))
    return np.stack(out)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """Weights, the prompt and the unsharded references, then the two
    ranks' run of every case: {case: (sharded, port, JAX) results}."""
    tmp = str(tmp_path_factory.mktemp("sharded"))
    prompt = np.random.default_rng(0).integers(0, 1000, (B, S), np.int32)
    np.save(os.path.join(tmp, "prompt.npy"), prompt)
    refs, weights = {}, {}
    for name, arch, kv, _ in CASES:
        key, empty = f"{arch}-{kv}", name in EMPTY
        ref_key = (key, empty, name if name in CP else None)
        if key not in weights:
            cfg_j = _cfg(jax_get_config, arch, kv)
            mj = jax_build_model(cfg_j, JaxFlags(remat=False))
            pj, _ = mj.init(jax.random.PRNGKey(0))
            flat = _flatten(jax.tree.map(np.asarray, pj))
            np.savez(os.path.join(tmp, key + ".npz"), **flat)
            weights[key] = (mj, pj)
        if ref_key not in refs:
            mj, pj = weights[key]
            cfg = _cfg(get_config, arch, kv)
            model = build_model(cfg, _flags(name))
            params = convert_params(jax.tree.map(np.asarray, pj), cfg, device="cpu")
            logits, toks = _greedy(model, params, torch.from_numpy(prompt), STEPS, empty=empty)
            refs[ref_key] = (logits, toks, _jax_logits(mj, pj, prompt, toks, empty))
    t0 = time.time()
    ctx = mp.start_processes(_rank, args=(os.path.join(tmp, "store"), tmp, CASES), nprocs=2,
                             join=False, start_method="spawn")
    while not ctx.join(timeout=max(1.0, LIMIT_S - (time.time() - t0))):
        if time.time() - t0 > LIMIT_S:
            for p in ctx.processes:
                p.terminate()
            pytest.fail(f"the two ranks did not finish within {LIMIT_S} s")
    out = {}
    for name, arch, kv, _ in CASES:
        got = np.load(os.path.join(tmp, f"out-{name}.npz"))
        with open(os.path.join(tmp, f"log-{name}.json")) as f:
            log = json.load(f)
        starts = [np.load(os.path.join(tmp, f"starts-{name}-{r}.npy")) for r in range(2)]
        out[name] = (got["logits"], got["toks"],
                     *refs[f"{arch}-{kv}", name in EMPTY, name if name in CP else None], log,
                     starts)
    return out


@pytest.mark.parametrize("case", [c[0] for c in CASES])
class TestShardedServing:
    def test_logits_match_unsharded_port(self, sharded, case):
        logits, toks, ref_logits, ref_toks, _, _, _ = sharded[case]
        np.testing.assert_allclose(logits, ref_logits, rtol=TOL, atol=TOL)

    def test_logits_match_jax(self, sharded, case):
        logits, toks, _, _, jax_logits, _, _ = sharded[case]
        np.testing.assert_allclose(logits, jax_logits, rtol=TOL, atol=TOL)

    def test_greedy_tokens_identical(self, sharded, case):
        _, toks, _, ref_toks, _, _, _ = sharded[case]
        np.testing.assert_array_equal(toks, ref_toks)

    def test_decode_keeps_the_cache_in_place(self, sharded, case):
        """Every decode step's calls over the self cache (whose 2 x STEPS or
        S + STEPS slots divide over "model") take the merge path, and no
        collective of the steps moves K, V or positions of the cache's
        shape: the merge all-reduces (B, H) and (B, H, dh + 1) parts."""
        name, arch, kv, shape = next(c for c in CASES if c[0] == case)
        cfg = _cfg(get_config, arch, kv)
        log = sharded[case][5]
        Sc = 2 * STEPS if case in EMPTY else S + STEPS
        assert len(log["calls"]) == cfg.n_layers * STEPS
        assert all(slots and merged for slots, merged in log["calls"]), log["calls"]
        assert not cache_moved(log["seen"], {Sc, Sc // shape[1]}, cfg.head_dim), log["seen"]
        rows, H = B // shape[0], cfg.n_heads  # the cache's rows: "kv_batch" over "data"
        merges = [c[1] for c in log["seen"] if c[0] == "all-reduce"
                  and c[1] in ([rows, H], [rows, H, cfg.head_dim + 1])]
        assert len(merges) == (2 * cfg.n_layers * STEPS if shape[1] > 1 else 0), log["seen"]


@pytest.mark.parametrize("case", list(CP))
def test_context_parallel_rows_start_at_the_rank_offset(sharded, case):
    """The context-parallel prefill's attention cores ran on S / 2 query
    rows a rank, one call a layer, rank r's from position r S / 2 (the
    flash wrapper's `q_offset`; the chunked core's positions, its query
    chunks shorter than the rows)."""
    cfg = _cfg(get_config, "llama2-7b", None)
    for r, starts in enumerate(sharded[case][6]):
        assert len(starts) == cfg.n_layers and (starts == [r * S // 2, S // 2]).all(), (r, starts)


@pytest.mark.parametrize("arch,shape", [("llama2-7b", "decode_32k"), ("glm4-9b", "train_4k")])
def test_dryrun_mesh_single_writes_counted_records(tmp_path, arch, shape):
    """`python -m repro_torch.launch.dryrun --mesh single` on one case: the
    step run as DTensors on the 16 x 16 mesh and one device's share
    counted: its peak with its parts (the arguments' local shards among
    them, equal to the argument bytes from the specs), `fits_h100` on the
    peak, dot FLOPs, collective bytes by the reference's five classes and
    the three roofline terms from them. Under DECODE_RULES the cache's
    slots are sharded over "model" and stay so (`kernels/ops.py`): no class
    holds the device's cache shard any more (until the decode merged its
    slot-sharded parts, llama2-7b's 32 KV heads, which divide 16 ways, took
    each layer's shard to a head sharding by an all-to-all, the whole cache
    a step); what moves is the weights' gathers, the activations and the
    merge's all-reduces of (B, H) and (B, H, dh + 1) f32 a layer."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.cost_analysis import COLLECTIVES, PARTS
    from repro_torch.launch.roofline import H100

    (rec,) = dryrun.main(["--arch", arch, "--shape", shape, "--mesh", "single",
                          "--out", str(tmp_path)])
    with open(tmp_path / f"{arch}__{shape}__single.json") as f:
        assert json.load(f) == json.loads(json.dumps(rec))
    assert rec["status"] == "ok" and rec["mesh"] == {"data": 16, "model": 16}
    assert rec["chips"] == 256 and rec["rules"] == dryrun.KIND_RULES[dryrun.SHAPES[shape].kind]
    assert "collective_counted" not in rec and "peak_counted" not in rec["memory"]
    m, c, r = rec["memory"], rec["cost"], rec["roofline"]
    assert m["peak_gb"] == pytest.approx(sum(m[k + "_gb"] for k in PARTS))
    assert m["fits_h100"] == (m["peak_gb"] * 1e9 <= H100.hbm_bytes)
    args = m["argument_parts_gb"]
    assert m["argument_gb"] == pytest.approx(sum(args.values())) and m["argument_gb"] > 0
    for part, gb in args.items():  # the local shards count from the start
        assert m[part + "_gb"] == pytest.approx(gb), part
    assert set(c["collective_bytes"]) == set(COLLECTIVES) and c["link_bw"] == H100.link_bw
    total = sum(c["collective_bytes"].values())
    assert total > 0 and r["collective_s"] == pytest.approx(total / H100.link_bw)
    assert r["chips"] == 256 and r["counted_flops_device"] == c["flops"] > 0
    assert r["compute_s"] == pytest.approx(c["flops"] / H100.flops)
    assert r["memory_s"] == pytest.approx(c["dot_bytes"] / H100.hbm_bw)
    assert r["useful_ratio"] == pytest.approx(r["model_flops"] / (256 * c["flops"]))
    if shape == "decode_32k":
        cfg = get_config(arch)
        spec = dryrun.SHAPES[shape]
        # layers x (k, v) x rows x slots x KV heads x dh x bf16, a 256th of each
        kv = cfg.n_layers * 2 * spec.batch * spec.seq * cfg.n_kv_heads * cfg.head_dim * 2 / 256
        assert m["cache_gb"] * 1e9 >= kv
        rows, H = spec.batch // 16, cfg.n_heads  # a device's rows ("kv_batch" over "data")
        merge = cfg.n_layers * 2 * (rows * H * 4 + rows * H * (cfg.head_dim + 1) * 4)
        assert merge <= c["collective_bytes"]["all-reduce"]
        assert c["collective_bytes"]["all-to-all"] < kv / 100
        assert sum(c["collective_bytes"].values()) < kv / 20
