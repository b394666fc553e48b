"""Sharded training of every family on two CPU ranks, against the unsharded
port and the JAX reference.

One `torch.multiprocessing` spawn of two gloo ranks (a `FileStore` under
the test's tmp dir, a 60 s process-group timeout, a LIMIT_S limit of its
own) runs each case's smoke config (f32, remat on) under
`sharding.use_mesh(mesh, TRAIN_RULES)`: FSDP over "data", tensor
parallelism over "model", as the reference's rule table places them. The
parameters go on the mesh as DTensors that require grad
(`Model.distribute_params`), `Model.loss` puts the batch on it by its
axes, and `make_train_step` takes one AdamW step. Each backward runs in
a thread of its own, as on the card, where autograd's device thread does
not see the caller's `use_mesh`:

  * dense: llama2-7b on (1, 2) and (2, 1);
  * vlm: qwen2-vl-72b on (1, 2) with one KV head, so "model" divides the
    query heads but not the KV heads, which each rank pairs with its query
    heads (their gradient a partial sum over "model");
  * moe: mixtral-8x22b (top-2, both aux losses) on (1, 2) and (2, 1) and
    under einsum dispatch on (1, 2), llama4-scout-17b-a16e (top-1) on
    (1, 2);
  * hybrid: zamba2-7b with a Mamba2 group, the shared block and a
    remainder layer on (1, 2), and on (2, 1) in chunks of 4;
  * ssm: xlstm-1.3b (an mLSTM group and an sLSTM block) on (1, 2);
  * enc-dec: seamless-m4t-large-v2 on (1, 2) and (2, 1);
  * context-parallel attention (`attn_seq_shard`, CASE_RULES): llama2-7b
    on (1, 2) under TRAIN_RULES_ATTNSP and TRAIN_RULES_CP_SP (the residual
    cut by rows too), llama4-scout-17b-a16e under TRAIN_RULES_EP_CP (experts
    over "model", heads whole): each rank's attention core takes its block
    of query rows, rank 1's starting at S / 2 (the cores record where).

The same weights (the reference's init with every constant leaf perturbed
from a seed, converted) and batch run unsharded in the port and through
`jax.value_and_grad(Model.loss)` in this process: the loss within LOSS_TOL
of both, every gradient leaf within GRAD_TOL of its largest magnitude in
both, the parameters and moments after one AdamW step within OPT_TOL of
the unsharded port's update on the same gradients, and each moment a
DTensor of its parameter's placements and local shape. Mamba2's chunks stay at 64 or fewer, where
the reference is finite (tests/test_torch_training_families.py).

Besides: two microbatches equal one under the mesh; `train_loop` trains
distributed parameters as it trains plain ones and refuses a checkpoint
directory for them; a replicated weight's gradient through
`sharding.run_local` is the sum over every rank's rows, which
`local_map`'s own default (the input's placements) would get wrong; and
every aten op that reached DTensor's dispatcher is one that
`chip_smoke.py` probes in the card's torch (`DTENSOR_OPS`).
"""

import concurrent.futures
import contextlib
import dataclasses
import datetime
import importlib.util
import os
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import RuntimeFlags as JaxFlags  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch import training  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import convert_params, restack, to_numpy  # noqa: E402
from repro_torch.models import RuntimeFlags, build_model  # noqa: E402

LOSS_TOL, GRAD_TOL, OPT_TOL = 2e-3, 2e-4, 1e-6
MICRO_TOL = 1e-5  # two microbatches against one: f32 rounding (tests/test_torch_training.py)
B, S, SE = 2, 12, 7  # batch, (decoder) sequence, encoder frames
LIMIT_S = 240  # the spawn's own time limit (it takes ~60 s on a CPU)
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
# (case name, arch, config fields replaced, RuntimeFlags fields, mesh shape)
CASES = [
    ("llama2-7b (1, 2)", "llama2-7b", {}, {}, (1, 2)),
    ("llama2-7b (2, 1)", "llama2-7b", {}, {}, (2, 1)),
    ("qwen2-vl-72b K=1 (1, 2)", "qwen2-vl-72b", {"n_kv_heads": 1}, {}, (1, 2)),
    ("mixtral-8x22b (1, 2)", "mixtral-8x22b", {}, {}, (1, 2)),
    ("mixtral-8x22b (2, 1)", "mixtral-8x22b", {}, {}, (2, 1)),
    ("mixtral-8x22b einsum dispatch (1, 2)", "mixtral-8x22b", {},
     {"moe_dispatch": "einsum"}, (1, 2)),
    ("llama4-scout-17b-a16e (1, 2)", "llama4-scout-17b-a16e", {}, {}, (1, 2)),
    ("zamba2-7b (1, 2)", "zamba2-7b", {"n_layers": 3}, {}, (1, 2)),
    ("zamba2-7b chunks of 4 (2, 1)", "zamba2-7b", {"n_layers": 3}, {"mamba_chunk": 4}, (2, 1)),
    ("xlstm-1.3b (1, 2)", "xlstm-1.3b", {}, {}, (1, 2)),
    ("seamless-m4t-large-v2 (1, 2)", "seamless-m4t-large-v2", {}, {}, (1, 2)),
    ("seamless-m4t-large-v2 (2, 1)", "seamless-m4t-large-v2", {}, {}, (2, 1)),
    ("llama2-7b ATTNSP (1, 2)", "llama2-7b", {}, {"attn_seq_shard": True}, (1, 2)),
    ("llama2-7b CP_SP (1, 2)", "llama2-7b", {}, {"attn_seq_shard": True}, (1, 2)),
    ("llama4-scout-17b-a16e EP_CP (1, 2)", "llama4-scout-17b-a16e", {},
     {"attn_seq_shard": True}, (1, 2)),
]
# the rule set of a case not under TRAIN_RULES: context-parallel attention, the
# attention core's query rows over "model" (`RuntimeFlags.attn_seq_shard`)
CASE_RULES = {"llama2-7b ATTNSP (1, 2)": "TRAIN_RULES_ATTNSP",
              "llama2-7b CP_SP (1, 2)": "TRAIN_RULES_CP_SP",
              "llama4-scout-17b-a16e EP_CP (1, 2)": "TRAIN_RULES_EP_CP"}
MICRO_CASE = ("llama2-7b", (2, 1))  # two microbatches against one, batch 2 B
LOOP_CASE = ("llama2-7b", (1, 2))  # train_loop, 2 steps


def _cfg(get, arch, fields):
    return dataclasses.replace(get(arch, smoke=True), dtype="float32", **fields)


def _key(arch, fields, flags):
    return arch + "".join(f"-{k}{v}" for k, v in sorted({**fields, **flags}.items()))


def _batch(cfg, batch=B, seed=12):
    """The loss's batch as numpy from `seed`: tokens (or vlm embeds, or
    enc-dec's encoder frames and decoder tokens) and labels."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (batch, S + 1)).astype(np.int32)
    out = {"labels": toks[:, 1:]}
    if cfg.n_encoder_layers:
        out["enc_embeds"] = (0.5 * rng.standard_normal((batch, SE, cfg.d_model))).astype(np.float32)
        out["dec_tokens"] = toks[:, :-1]
    elif cfg.embeds_input:
        out["embeds"] = (0.5 * rng.standard_normal((batch, S, cfg.d_model))).astype(np.float32)
    else:
        out["tokens"] = toks[:, :-1]
    return out


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


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
    plus 0.1 N(0, 1) from `seed`, so that a gamma or bias cut or summed on
    the wrong shard shows in its gradient; the xLSTM gate biases plus
    N(0, 1), so that the mLSTM's input gates decide some denominators
    (tests/test_torch_sharded_families.py)."""
    rng = np.random.default_rng(seed)
    return {k: (v + (1.0 if k.endswith(("b_if", "b_gates")) else 0.1)
                * rng.standard_normal(v.shape)).astype(v.dtype)
            if v.size > 1 and np.all(v == v.flat[0]) else v for k, v in flat.items()}


def _port(cfg, flags, tmp, key):
    model = build_model(cfg, RuntimeFlags(**flags))
    params = convert_params(_unflatten(np.load(os.path.join(tmp, key + ".npz"))), cfg,
                            device="cpu")
    return model, params


def _whole(t):
    """A (D)Tensor's whole value as numpy, the same on every rank."""
    from repro_torch.sharding import whole

    return whole(t.detach()).numpy()


def _loss_and_grads(model, params, batch, seen=None):
    """(loss, {name: gradient}) of one batch, every gradient whole. The
    backward runs in a thread of its own, as autograd runs it on the card
    (a device thread, which does not see the caller's `use_mesh`): remat's
    recompute must still run under the mesh. With `seen`, the thread
    records its DTensor ops there too (a dispatch mode is thread-local)."""
    loss, _ = model.loss(params, batch)
    names, leaves = zip(*params.named_parameters())

    def backward():
        with _ops_recorder(seen) if seen is not None else contextlib.nullcontext():
            return torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        grads = pool.submit(backward).result()
    return float(_whole(loss)), {n: _whole(g) for n, g in zip(names, grads)}


def _step(model, params, batch, microbatches=1):
    """One AdamW step -> (its metrics as floats, {"param/", "mu/", "nu/"
    name: whole array}, each moment placed like its parameter)."""
    from torch.distributed.tensor import DTensor

    step = training.make_train_step(model, training.AdamWConfig(**OPT), microbatches)
    params, state, metrics = step(params, training.adamw_init(params), batch)
    out, placed = {}, []
    for n, p in params.named_parameters():
        out["param/" + n] = _whole(p)
        for k in ("mu", "nu"):
            m = state[k][n]
            out[f"{k}/{n}"] = _whole(m)
            placed.append(isinstance(p, DTensor) == isinstance(m, DTensor)
                          and m.dtype == torch.float32
                          and (not isinstance(p, DTensor) or (
                              m.placements == p.placements
                              and m.to_local().shape == p.to_local().shape)))
    return {k: float(v) for k, v in metrics.items()}, out, placed


def _ops_recorder(seen):
    """A dispatch mode that adds to `seen` every aten op called with a
    DTensor among its arguments (outside `local_map`, which hands its
    function plain local tensors)."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    class Recorder(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                seen.add(str(func))
            return func(*args, **(kwargs or {}))

    return Recorder()


@contextlib.contextmanager
def _recorded_rows(starts):
    """While inside, each call of the plain attention cores appends (its
    first query position, its query rows) to `starts`: on local shards
    under a mesh, the rank's own rows (`attention._local_core`)."""
    from repro_torch.models import attention

    saved = attention.naive_attention, attention.chunked_attention

    def wrap(fn):
        def core(q, k, v, q_pos, *rest):
            starts.append((int(q_pos[0, 0]), q.shape[1]))
            return fn(q, k, v, q_pos, *rest)
        return core

    attention.naive_attention, attention.chunked_attention = map(wrap, saved)
    try:
        yield
    finally:
        attention.naive_attention, attention.chunked_attention = saved


def _replicated_weight_grads(mesh):
    """y = x * g on local shards, x's rows (4, 3) sharded over the mesh's
    first dim, g (3,) replicated; the loss sums y. -> (g's gradient through
    `sharding.run_local`, through `local_map` with its default gradient
    placements), whole."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch import sharding as sh

    x = torch.arange(12, dtype=torch.float32).view(4, 3)
    rows, rep = [Shard(0), Replicate()], [Replicate(), Replicate()]
    out = []
    for call in (lambda f, a, b: sh.run_local(f, rows, (rows, rep), a, b),
                 lambda f, a, b: local_map(f, rows, (rows, rep), device_mesh=mesh)(a, b)):
        xd = sh._distribute(x, mesh, rows)
        g = sh.replicated_like(xd, torch.ones(3)).requires_grad_(True)
        y = call(lambda a, b: a * b, xd, g)
        (dg,) = torch.autograd.grad(sh.redistribute(y.sum(), rep), (g,))
        out.append(_whole(dg))
    return out


def _rank(rank, store, tmp, cases):
    """One gloo rank: every case's loss, gradients and step under its mesh,
    then the microbatch, train_loop and replicated-weight checks; each rank
    saves what it saw (whole tensors) and the DTensor ops it recorded."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import sharding as sh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=60))
    seen = set()
    try:
        with _ops_recorder(seen):
            for name, arch, fields, flags, shape in cases:
                cfg = _cfg(get_config, arch, fields)
                key = _key(arch, fields, flags)
                batch = _torch_batch(_batch(cfg))
                mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
                starts = []
                with sh.use_mesh(mesh, getattr(sh, CASE_RULES.get(name, "TRAIN_RULES"))), \
                        _recorded_rows(starts):
                    model, params = _port(cfg, flags, tmp, key)
                    loss, grads = _loss_and_grads(
                        model, model.distribute_params(params.requires_grad_(True)), batch, seen)
                    model, params = _port(cfg, flags, tmp, key)
                    metrics, after, placed = _step(
                        model, model.distribute_params(params.requires_grad_(True)), batch)
                np.savez(os.path.join(tmp, f"out-{name}-{rank}.npz"), loss=loss,
                         placed=np.array(placed, bool), q_starts=np.array(starts, int),
                         **{"grad/" + n: g for n, g in grads.items()}, **after,
                         **{"metric/" + k: v for k, v in metrics.items()})

            arch, shape = MICRO_CASE
            cfg = _cfg(get_config, arch, {})
            batch = _torch_batch(_batch(cfg, batch=2 * B, seed=30))
            mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
            micro = {}
            with sh.use_mesh(mesh, sh.TRAIN_RULES):
                for mb in (1, 2):
                    model, params = _port(cfg, {}, tmp, _key(arch, {}, {}))
                    metrics, after, _ = _step(
                        model, model.distribute_params(params.requires_grad_(True)), batch, mb)
                    micro.update({f"{mb}/{k}": v for k, v in metrics.items()},
                                 **{f"{mb}/{k}": v for k, v in after.items() if k[:3] == "mu/"})
            np.savez(os.path.join(tmp, f"micro-{rank}.npz"), **micro)

            arch, shape = LOOP_CASE
            cfg = _cfg(get_config, arch, {})
            mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
            with sh.use_mesh(mesh, sh.TRAIN_RULES):
                model, params = _port(cfg, {}, tmp, _key(arch, {}, {}))
                dparams = model.distribute_params(params.requires_grad_(True))
                _, hist = _train_loop(model, cfg, dparams)
                try:
                    _train_loop(model, cfg, dparams, ckpt_dir=os.path.join(tmp, f"ck{rank}"))
                    refused = False
                except ValueError as e:
                    refused = "distributed" in str(e)
            np.savez(os.path.join(tmp, f"loop-{rank}.npz"),
                     losses=np.array([h["loss"] for h in hist]), refused=refused,
                     wrote=os.path.exists(os.path.join(tmp, f"ck{rank}")))

        mesh = init_device_mesh("cpu", (2, 1), mesh_dim_names=("data", "model"))
        good, default = _replicated_weight_grads(mesh)
        np.savez(os.path.join(tmp, f"rep-{rank}.npz"), good=good, default=default,
                 ops=np.array(sorted(seen)))
    finally:
        dist.destroy_process_group()


def _train_loop(model, cfg, params, ckpt_dir=None):
    """`train_loop` for 2 steps on a small synthetic stream."""
    return training.train_loop(
        model, training.DataConfig(vocab_size=cfg.vocab_size, seq_len=S, batch_size=B, seed=5),
        training.AdamWConfig(**OPT), n_steps=2, ckpt_dir=ckpt_dir, ckpt_every=1, log_every=1,
        log_fn=lambda s: None, params=params)


def _reference(cfg, flags, mj, pj, batch, tmp, key):
    """The unsharded port's loss and gradients, and JAX's loss and gradients
    (port-named), on the same weights and batch."""
    model, params = _port(cfg, flags, tmp, key)
    loss, grads = _loss_and_grads(model, params.requires_grad_(True), _torch_batch(batch))
    (lj, _), gj = jax.jit(jax.value_and_grad(mj.loss, has_aux=True))(
        pj, {k: jnp.asarray(v) for k, v in batch.items()})
    return {"loss": loss, "grads": grads, "jax_loss": float(lj),
            "jax_grads": _flatten(jax.tree.map(np.asarray, gj)),
            "update": lambda g: _unsharded_update(cfg, flags, tmp, key, g)}


def _unsharded_update(cfg, flags, tmp, key, grads):
    """The unsharded port's AdamW step from the case's weights on `grads`
    (whole arrays by name) -> (its metrics as floats, {"param/", "mu/",
    "nu/" name: array})."""
    _, params = _port(cfg, flags, tmp, key)
    params, state, metrics = training.adamw_update(
        training.AdamWConfig(**OPT), params, {n: torch.tensor(g) for n, g in grads.items()},
        training.adamw_init(params))
    out = {}
    for n, p in params.named_parameters():
        out["param/" + n] = p.detach().numpy()
        out["mu/" + n], out["nu/" + n] = state["mu"][n].numpy(), state["nu"][n].numpy()
    return {k: float(v) for k, v in metrics.items()}, out


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """Weights, then the two ranks' run of every case, while the unsharded
    port and JAX run here: {"cases": {case: (each rank's output, the
    references)}, "micro", "loop", "rep": each rank's output, "loop_ref":
    the unsharded train_loop's losses}."""
    tmp = str(tmp_path_factory.mktemp("sharded_training"))
    jax_models = {}
    for _, arch, fields, flags, _ in CASES:
        key = _key(arch, fields, flags)
        if key not in jax_models:
            cfg_j = _cfg(jax_get_config, arch, fields)
            mj = jax_build_model(cfg_j, JaxFlags(remat=False, **flags))
            pj = jax.jit(lambda k, m=mj: m.init(k)[0])(jax.random.PRNGKey(0))
            flat = _perturbed(_flatten(jax.tree.map(np.asarray, pj)), seed=len(jax_models))
            np.savez(os.path.join(tmp, key + ".npz"), **flat)
            jax_models[key] = (mj, jax.tree.map(jnp.asarray, _unflatten(
                np.load(os.path.join(tmp, key + ".npz")))))
    t0 = time.time()
    ctx = mp.start_processes(_rank, args=(os.path.join(tmp, "store"), tmp, CASES), nprocs=2,
                             join=False, start_method="spawn")
    refs = {}
    try:
        for _, arch, fields, flags, _ in CASES:  # the references, while the ranks run
            key = _key(arch, fields, flags)
            if key not in refs:
                cfg = _cfg(get_config, arch, fields)
                refs[key] = _reference(cfg, flags, *jax_models[key], _batch(cfg), tmp, key)
        cfg = _cfg(get_config, LOOP_CASE[0], {})
        model, params = _port(cfg, {}, tmp, _key(LOOP_CASE[0], {}, {}))
        loop_ref = [h["loss"] for h in _train_loop(model, cfg, params)[1]]
    finally:
        while not ctx.join(timeout=max(1.0, LIMIT_S - (time.time() - t0))):
            if time.time() - t0 > LIMIT_S:
                for p in ctx.processes:
                    p.terminate()
                pytest.fail(f"the two ranks did not finish within {LIMIT_S} s")

    def load(stem):
        return [dict(np.load(os.path.join(tmp, f"{stem}-{r}.npz"))) for r in range(2)]

    return {"cases": {name: (load(f"out-{name}"), refs[_key(arch, fields, flags)])
                      for name, arch, fields, flags, _ in CASES},
            "micro": load("micro"), "loop": load("loop"), "rep": load("rep"),
            "loop_ref": loop_ref}


def _close_of_largest(got, want, tol, what):
    assert np.isfinite(got).all(), f"{what}: non-finite"
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.astype(np.float32) - want.astype(np.float32)).max())
    assert err <= tol * scale, f"{what}: max|err| {err:.3g} > {tol} x {scale:.3g}"


def _by_prefix(out, prefix):
    return {k[len(prefix):]: v for k, v in out.items() if k.startswith(prefix)}


@pytest.mark.parametrize("case", [c[0] for c in CASES])
class TestShardedTraining:
    def test_loss_matches_unsharded_port_and_jax(self, sharded, case):
        ranks, ref = sharded["cases"][case]
        for out in ranks:
            loss = float(out["loss"])
            assert abs(loss - ref["loss"]) <= LOSS_TOL * max(1.0, abs(ref["loss"])), \
                (loss, ref["loss"])
            assert abs(loss - ref["jax_loss"]) <= LOSS_TOL * max(1.0, abs(ref["jax_loss"])), \
                (loss, ref["jax_loss"])

    def test_gradients_match_unsharded_port(self, sharded, case):
        ranks, ref = sharded["cases"][case]
        for out in ranks:
            grads = _by_prefix(out, "grad/")
            assert set(grads) == set(ref["grads"])
            for n, g in grads.items():
                _close_of_largest(g, ref["grads"][n], GRAD_TOL, f"{case} d{n}")

    def test_gradients_match_jax(self, sharded, case):
        """Every leaf of `jax.value_and_grad(Model.loss)`, the port's
        gradients restacked into the reference's tree."""
        ranks, ref = sharded["cases"][case]
        for out in ranks:
            got = _flatten(jax.tree.map(to_numpy, restack(
                {n: torch.from_numpy(g) for n, g in _by_prefix(out, "grad/").items()})))
            assert set(got) == set(ref["jax_grads"])
            for path, g in got.items():
                _close_of_largest(g, ref["jax_grads"][path], GRAD_TOL, f"{case} d{path}")

    def test_step_matches_unsharded_port(self, sharded, case):
        """One AdamW step under the mesh against the unsharded port's on the
        same weights and the same (whole) gradients: the clip's norm, which
        must be over the whole gradient, the lr, every parameter and both
        moments; the step's loss is the loss's. (The gradients themselves
        differ from the unsharded ones by their sums' rounding, which the
        first moment would carry past OPT_TOL: they are held at GRAD_TOL
        above.)"""
        ranks, ref = sharded["cases"][case]
        for out in ranks:
            metrics, want = ref["update"](_by_prefix(out, "grad/"))
            for k in ("grad_norm", "lr"):
                got = float(out["metric/" + k])
                assert abs(got - metrics[k]) <= OPT_TOL * max(1.0, abs(metrics[k])), \
                    (k, got, metrics[k])
            assert abs(float(out["metric/loss"]) - float(out["loss"])) <= OPT_TOL
            after = {k: v for k, v in out.items() if k.split("/")[0] in ("param", "mu", "nu")}
            assert set(after) == set(want)
            for k, v in after.items():
                _close_of_largest(v, want[k], OPT_TOL, f"{case} {k}")

    def test_moments_placed_like_parameters(self, sharded, case):
        """Each moment is an f32 DTensor of its parameter's placements and
        local shape, on both ranks."""
        ranks, _ = sharded["cases"][case]
        for out in ranks:
            assert out["placed"].size and out["placed"].all()


@pytest.mark.parametrize("case", [c[0] for c in CASES if c[3].get("attn_seq_shard")])
def test_context_parallel_rows_start_at_the_rank_offset(sharded, case):
    """Under context parallelism every attention core call of the loss and
    the step (forward and remat's recompute) runs on S / 2 query rows,
    rank r's starting at position r S / 2."""
    ranks, _ = sharded["cases"][case]
    for r, out in enumerate(ranks):
        starts = out["q_starts"]
        assert len(starts) and (starts == [r * S // 2, S // 2]).all(), (r, starts)


def test_two_microbatches_equal_one(sharded):
    """Under the mesh, two halves of the batch (each sharded over "data"),
    their gradients summed as f32 DTensors and halved, against the whole
    batch: the same loss, norm and first moment (1 - b1) g, to f32
    rounding (the parameters after a first Adam step, ~lr sign(g), are not
    compared: rounding flips it where g is near 0)."""
    for out in sharded["micro"]:
        for k in ("loss", "grad_norm"):
            a, b = float(out["1/" + k]), float(out["2/" + k])
            assert abs(a - b) <= MICRO_TOL * max(1.0, abs(a)), (k, a, b)
        mus = _by_prefix(out, "1/mu/")
        assert mus
        for n, m in mus.items():
            _close_of_largest(out["2/mu/" + n], m, MICRO_TOL, f"first moment {n}")


def test_train_loop_under_a_mesh(sharded):
    """`train_loop` given distributed parameters trains them: its losses
    equal the unsharded loop's on the same stream; with a checkpoint
    directory it raises, naming distributed parameters, and writes
    nothing."""
    for out in sharded["loop"]:
        np.testing.assert_allclose(out["losses"], sharded["loop_ref"], rtol=LOSS_TOL)
        assert bool(out["refused"]) and not bool(out["wrote"])


def test_replicated_weight_gradient_is_the_rows_sum(sharded):
    """g replicated, x's rows sharded over "data": g's gradient is the sum
    of x over every rank's rows, as `run_local` declares it (a partial sum,
    reduced); under `local_map`'s default (the input's own placements) each
    rank's part of the sum is taken for the whole."""
    want = np.arange(12, dtype=np.float32).reshape(4, 3).sum(0)
    for out in sharded["rep"]:
        np.testing.assert_array_equal(out["good"], want)
        assert not np.array_equal(out["default"], want)


def test_dtensor_ops_probed_on_the_card(sharded):
    """Every aten op that reached DTensor's dispatcher on these training
    paths is in `chip_smoke.DTENSOR_OPS`, which the card's run probes for a
    sharding rule before any sharded run (the card's torch lacks ops this
    one has)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    seen = set().union(*(set(out["ops"].tolist()) for out in sharded["rep"]))
    assert seen
    missing = sorted(seen - set(chip_smoke.DTENSOR_OPS))
    assert not missing, "not in DTENSOR_OPS: " + " ".join(missing)
