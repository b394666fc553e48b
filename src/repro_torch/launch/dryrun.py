"""Dry run: every (arch x shape) step counted on the meta device (the port's
counterpart of `repro/launch/dryrun.py`), on one H100 (`--mesh h100`, the
default) or laid out on the reference's production meshes (`--mesh single`:
16 x 16 ("data", "model"), 256 cards; `--mesh multi`: 2 x 16 x 16 ("pod",
"data", "model"), 512; `--mesh both`).

Per one-card case:
  * specs.build_case(...)           -> the step and its meta arguments
  * cost_analysis.analyze_case(...) -> dot FLOPs, dot traffic and the peak
                                       of live bytes with its parts
  * derive_roofline(..., H100)      -> the three roofline terms, chips = 1

Nothing is computed and nothing is allocated: no card is needed. This is
analysis, not a CPU fallback. Most full-size cases do not fit one 80 GB
card (train_4k at batch 256, say); `fits_h100` says which do.

Every case is counted in full. The ssm family's sLSTM runs a loop over
time steps (~6.7e6 meta ops for xlstm-1.3b's prefill_32k, ~3 min): its
FLOPs are affine in the length, but its peak is not (the largest of several
affine terms: counted at 256 and 512 tokens and extrapolated, the peak
reads 83.6 GB against the 193.9 GB of the full count), so nothing is
scaled. Cases run in a spawned pool, one process a core, longest first.

Per mesh case, on a `DeviceMesh` of the card's device type over a process
group of 256 or 512 ranks on the `fake` backend (`launch.mesh`; this
process is rank 0, nothing moves), inside `sharding.use_mesh(mesh,
case.rules)`:

  * specs.build_case(...)           -> the step, its meta arguments, the
                                       kind's rule set (or `--rules`) and
                                       every argument's axes
  * the arguments put on the mesh by their axes (`Model.distribute_params`,
    `sharding.distribute_tree`): each rank's meta shard, cut locally
  * cost_analysis.analyze_case(...) -> the step run once as DTensors, rank
                                       0's share counted: dot FLOPs and
                                       traffic on its local shards, its
                                       peak of live bytes with its parts,
                                       and its collective bytes by class
  * derive_roofline(..., H100)      -> the three terms of one device, the
                                       collective term over `H100.link_bw`

and the device's argument bytes by part (`argument_bytes`, from the specs).
DTensor picks the collectives as it would on the card's NCCL: a partial
sum to a shard is a reduce-scatter, a shard of one dim to another an
all-to-all (`sharding.redistribute`). Decode keeps a cache whose slots
are sharded in place (`kernels/ops.py`): its step counts q's head gather
and the two all-reduces that merge the ranks' (output, lse) parts, not the
cache. Under a context-parallel rule set with `--attn-seq-shard` each rank
computes its own block of query rows, as the reference's partition does:
the attention core (counted as its naive or chunked form, the meta device
having no kernel) and the block's Q/K/V and MLP products on those rows,
K and V gathered over the sequence (`models/attention.py`,
`models/mlp.py`).

Results land in benchmarks/results/dryrun_h100/<arch>__<shape>__<mesh>.json
(mesh: h100, single or multi; `--tag` names a variant).

Usage:
  python -m repro_torch.launch.dryrun --arch glm4-9b --shape train_4k
  python -m repro_torch.launch.dryrun --all
  python -m repro_torch.launch.dryrun --all --mesh both
  python -m repro_torch.launch.dryrun --arch mixtral-8x22b --shape train_4k --mesh single \
      --rules train_ep_cp --moe-dispatch einsum --attn-seq-shard --tag ep_cp
  python -m repro_torch.launch.dryrun --all --skip-existing
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import logging
import math
import multiprocessing
import os
import time
import traceback
from typing import Dict, List, Optional, Sequence, Union

from torch.distributed.device_mesh import init_device_mesh

from .. import sharding as sh
from ..configs import get_config
from ..training import adamw_init
from .cost_analysis import COLLECTIVES, PARTS, analyze_case
from .mesh import MULTI, SINGLE, fake_process_group
from .roofline import H100, derive_roofline
from .specs import SHAPES, ShapeSpec, build_case, skip_reason

# package logger: importable callers capture or filter case lines; the CLI
# wires a handler that prints "[dryrun] ..."
logger = logging.getLogger("repro_torch.launch.dryrun")

ASSIGNED = [
    "qwen1.5-110b", "qwen2-vl-72b", "mixtral-8x22b", "seamless-m4t-large-v2",
    "glm4-9b", "nemotron-4-15b", "zamba2-7b", "mistral-large-123b",
    "xlstm-1.3b", "llama4-scout-17b-a16e",
]
OUT = os.path.join("benchmarks", "results", "dryrun_h100")
# the reference's production meshes; a case runs on one of them or on one
# card ("h100"); "card" is one card's own (1, 1) mesh, on which chip_smoke.py
# holds the counted peak of a sharded step against the measured one
MESHES = {"single": SINGLE, "multi": MULTI, "card": ((1, 1), SINGLE[1])}
MESH_ARGS = {"h100": ["h100"], "single": ["single"], "multi": ["multi"],
             "both": ["single", "multi"]}
# each step kind's rule set, and --rules: the reference's override names
# (`repro/launch/dryrun.py`) and the tables they take
KIND_RULES = {"train": "TRAIN_RULES", "prefill": "PREFILL_RULES", "decode": "DECODE_RULES"}
RULES = {
    "train_sp": "TRAIN_RULES_SP",
    "decode_v2": "DECODE_RULES_V2",
    "train_attnsp": "TRAIN_RULES_ATTNSP",
    "train_cp_sp": "TRAIN_RULES_CP_SP",
    "decode_v3": "DECODE_RULES_V3",
    "train_fsdp": "TRAIN_RULES_FSDP",
    "train_ep_cp": "TRAIN_RULES_EP_CP",
    "train_ep_cp_sp": "TRAIN_RULES_EP_CP_SP",
    "decode_v3_ep": "DECODE_RULES_V3_EP",
}


def _label(arch: str, shape_name: str, tag: str = "", mesh: str = "h100") -> str:
    return f"{arch}__{shape_name}__{mesh}" + (f"__{tag}" if tag else "")


def argument_bytes(case, mesh) -> Dict[str, int]:
    """One device's argument bytes by part (of PARTS) when `case`'s
    arguments are laid out on `mesh` by their axes under the case's rules:
    each leaf's local shard, summed."""
    out = dict.fromkeys(PARTS, 0)
    with sh.use_mesh(mesh, case.rules):
        for part, arg, axes in zip(case.arg_parts, case.args, case.arg_axes):
            out[part] += sh.local_bytes(arg, axes)
    return out


def _on_mesh(case) -> tuple:
    """`case.args` on the active mesh by their axes (each rank's shard); the
    optimizer's moments placed like their parameters and its step a plain
    scalar, as `adamw_init` makes them."""
    out: list = []
    for part, arg, axes in zip(case.arg_parts, case.args, case.arg_axes):
        if part == "params":
            out.append(case.model.distribute_params(arg))
        elif part == "moments":
            out.append(adamw_init(out[0]))
        else:
            out.append(sh.distribute_tree(arg, axes))
    return tuple(out)


def _mesh_record(case, mesh_name: str) -> dict:
    """A mesh case's step counted on one device (module docstring)."""
    shape, names = MESHES[mesh_name]
    chips = math.prod(shape)
    with fake_process_group(chips):
        mesh = init_device_mesh("cuda", shape, mesh_dim_names=names)
        args_bytes = argument_bytes(case, mesh)
        with sh.use_mesh(mesh, case.rules):
            cost = analyze_case(case, args=_on_mesh(case))
    roof = derive_roofline(cost, case.cfg, case.shape, chips=chips, hw=H100)
    return {
        "mesh": dict(zip(names, shape)),
        "chips": chips,
        "n_ops": cost.n_ops,
        "memory": {**{f"{k}_gb": v / 1e9 for k, v in cost.parts.items()},
                   "peak_gb": cost.peak_bytes / 1e9,
                   "argument_gb": sum(args_bytes.values()) / 1e9,
                   "argument_parts_gb": {k: v / 1e9 for k, v in args_bytes.items() if v},
                   "fits_h100": cost.peak_bytes <= H100.hbm_bytes},
        "cost": {"flops": cost.flops, "dot_bytes": cost.dot_bytes,
                 "collective_bytes": cost.collective_bytes,
                 "link_bw": H100.link_bw},
        "roofline": roof.as_dict(),
    }


def run_case(arch: str, shape: Union[str, ShapeSpec], out_dir: Optional[str] = OUT,
             tag: str = "", rt_kwargs: Optional[dict] = None, microbatches: int = 1,
             cfg_kwargs: Optional[dict] = None, mesh: str = "h100",
             rules: Optional[str] = None) -> dict:
    """One case's record (written to `out_dir` unless it is None), on one
    card ("h100") or on a production mesh (`MESHES`), there under the
    kind's rule set or `rules` (a name of RULES)."""
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    label = _label(arch, shape.name, tag, mesh)
    t0 = time.time()
    cfg = get_config(arch)
    if cfg_kwargs:
        cfg = dataclasses.replace(cfg, **cfg_kwargs)
    reason = skip_reason(cfg, shape)
    if reason:
        rec = {"case": label, "status": "skipped", "reason": reason}
        _write(out_dir, label, rec)
        return rec
    table = RULES[rules] if rules else KIND_RULES[shape.kind]
    try:
        case = build_case(arch, shape, rules_override=getattr(sh, table), rt_kwargs=rt_kwargs,
                          microbatches=microbatches, cfg_kwargs=cfg_kwargs)
        head = {"case": label, "status": "ok", "arch": arch, "shape": shape.name,
                "seq": shape.seq, "batch": shape.batch}
        if mesh != "h100":
            rec = {**head, "rules": table, "flags": rt_kwargs or {},
                   **_mesh_record(case, mesh), "analyze_s": round(time.time() - t0, 2)}
        else:
            cost = analyze_case(case)
            rec = {
                **head,
                "chips": 1,
                "analyze_s": round(time.time() - t0, 2),
                "n_ops": cost.n_ops,
                "memory": {
                    **{f"{k}_gb": v / 1e9 for k, v in cost.parts.items()},
                    "peak_gb": cost.peak_bytes / 1e9,
                    "fits_h100": cost.peak_bytes <= H100.hbm_bytes,
                },
                "cost": {"flops": cost.flops, "dot_bytes": cost.dot_bytes},
                "roofline": derive_roofline(cost, cfg, shape, chips=1, hw=H100).as_dict(),
            }
    except Exception as e:  # a failure here is a fault in the port's step
        rec = {
            "case": label,
            "status": "error",
            "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc()[-4000:],
        }
    _write(out_dir, label, rec)
    return rec


def _write(out_dir: Optional[str], label: str, rec: dict) -> None:
    if out_dir is None:
        return
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, label + ".json"), "w") as f:
        json.dump(rec, f, indent=1, default=float)


def case_line(rec: dict) -> str:
    """One line for a record: the peak and its parts, what fits, the dot
    FLOPs, on a mesh the collective bytes by class, and the terms."""
    if rec["status"] == "skipped":
        return f"{rec['case']}: SKIP ({rec['reason'].split(';')[0]})"
    if rec["status"] == "error":
        return f"{rec['case']}: ERROR {rec['error'][:200]}"
    m, r, c = rec["memory"], rec["roofline"], rec["cost"]
    parts = " ".join(f"{k} {m[k + '_gb']:.3f}" for k in PARTS)
    where = f"{rec['chips']} chips {rec['rules']}" if "mesh" in rec else "one card"
    line = (f"{rec['case']}: OK {where}, per device: peak {m['peak_gb']:.3f} GB ({parts}) "
            f"fits_h100={m['fits_h100']} flops {c['flops']:.4g}")
    terms = f"{r['compute_s']:.4g}/{r['memory_s']:.4g}"
    if "mesh" in rec:
        line += " collectives GB " + " ".join(
            f"{k} {c['collective_bytes'][k] / 1e9:.4g}" for k in COLLECTIVES)
        terms = f"(c/m/x)={terms}/{r['collective_s']:.4g}"
    else:
        terms = f"(c/m)={terms}"
    return (f"{line} terms{terms}s dom={r['dominant']} useful={r['useful_ratio']:.3f} "
            f"({rec['analyze_s']:.1f} s)")


def _work(arch: str, shape: ShapeSpec) -> int:
    """A rough count of the loop bodies a case dispatches, to start the
    longest first: each attention's chunk pairs (past naive_below keys; an
    enc-dec decoder layer attends twice, zamba2 once a group), each layer's
    sLSTM time steps, three passes to train. A mesh case runs the same
    loops on its local shards."""
    cfg = get_config(arch)
    if shape.kind == "decode":
        return cfg.n_layers
    pairs = math.ceil(shape.seq / 1024) ** 2 if shape.seq > 2048 else 1
    if cfg.family == "ssm":
        attn, steps = 0, shape.seq
    elif cfg.family == "hybrid":
        attn, steps = cfg.n_layers // cfg.shared_attn_every, 0
    else:
        attn, steps = cfg.n_encoder_layers + cfg.n_layers * (2 if cfg.n_encoder_layers else 1), 0
    return (attn * pairs + cfg.n_layers * (1 + steps)) * (3 if shape.kind == "train" else 1)


def run_cases(cases: Sequence[tuple], out_dir: Optional[str] = OUT,
              workers: Optional[int] = None, **kw) -> List[dict]:
    """Every case of `cases`, (arch, shape), (arch, shape, cfg_kwargs),
    (arch, shape, cfg_kwargs, mesh) or (arch, shape, cfg_kwargs, mesh,
    options) with a shape name or a ShapeSpec, "h100" (the default) or a
    name of MESHES, and `options` the case's own `run_case` arguments
    (rules, rt_kwargs, tag) over `kw`; each in a process of a spawned pool
    of `workers` (default: one a core this process may run on) when there
    is more than one; records in the order of `cases`, each logged as it
    ends."""
    cases = [(c[0], SHAPES[c[1]] if isinstance(c[1], str) else c[1],
              c[2] if len(c) > 2 else None, c[3] if len(c) > 3 else "h100",
              {**kw, **(c[4] if len(c) > 4 else {})}) for c in cases]
    workers = min(workers or len(os.sched_getaffinity(0)), len(cases))
    if workers <= 1:
        recs = []
        for arch, shape, cut, mesh, opts in cases:
            recs.append(run_case(arch, shape, out_dir, cfg_kwargs=cut, mesh=mesh, **opts))
            logger.info("%s", case_line(recs[-1]))
        return recs
    ctx = multiprocessing.get_context("spawn")
    order = sorted(range(len(cases)), key=lambda i: -_work(cases[i][0], cases[i][1]))
    with concurrent.futures.ProcessPoolExecutor(workers, mp_context=ctx) as pool:
        futs = {pool.submit(run_case, arch, shape, out_dir, cfg_kwargs=cut, mesh=mesh, **opts): i
                for i in order for arch, shape, cut, mesh, opts in [cases[i]]}
        recs: Dict[int, dict] = {}
        for f in concurrent.futures.as_completed(futs):
            recs[futs[f]] = f.result()
            logger.info("%s", case_line(recs[futs[f]]))
    return [recs[i] for i in range(len(cases))]


def parser() -> argparse.ArgumentParser:
    """The CLI: the reference's flags (`--rules`, `--moe-dispatch`,
    `--attn-seq-shard` with its choices) and `--mesh h100` besides."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", default="h100", choices=list(MESH_ARGS),
                    help="one H100, or the production meshes (single: 16x16, multi: "
                         "2x16x16, both), each device's step counted under DTensor")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--tag", default="", help="variant tag for the JSON name")
    ap.add_argument("--moe-dispatch", default=None, choices=["einsum", "scatter"])
    ap.add_argument("--rules", default=None, choices=list(RULES),
                    help="rule-set override on the meshes")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--attn-seq-shard", action="store_true")
    ap.add_argument("--attention-impl", default=None)
    return ap


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    logging.basicConfig(level=logging.INFO, format="[dryrun] %(message)s")
    args = parser().parse_args(argv)

    rt_kwargs = {}
    if args.moe_dispatch:
        rt_kwargs["moe_dispatch"] = args.moe_dispatch
    if args.attn_seq_shard:
        rt_kwargs["attn_seq_shard"] = True
    if args.attention_impl:
        rt_kwargs["attention_impl"] = args.attention_impl
    archs = ASSIGNED if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    cases = []
    for arch in archs:
        for shape in shapes:
            for mesh in MESH_ARGS[args.mesh]:
                path = os.path.join(args.out, _label(arch, shape, args.tag, mesh) + ".json")
                if args.skip_existing and os.path.exists(path):
                    with open(path) as f:
                        if json.load(f).get("status") in ("ok", "skipped"):
                            continue
                cases.append((arch, shape, None, mesh))
    recs = run_cases(cases, args.out, tag=args.tag, rt_kwargs=rt_kwargs or None,
                     microbatches=args.microbatches, rules=args.rules)
    n = {st: sum(r["status"] == st for r in recs) for st in ("ok", "skipped", "error")}
    logger.info("done: %d ok, %d skipped, %d errors", n["ok"], n["skipped"], n["error"])
    if n["error"]:
        raise SystemExit(1)
    return recs


if __name__ == "__main__":
    main()
