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

Per mesh case, on a `DeviceMesh` over a process group of 256 or 512 ranks
on the `fake` backend (`launch.mesh`; nothing runs, nothing moves):

  * specs.build_case(...)           -> the step's meta arguments, the kind's
                                       rule set and every argument's axes
  * sharding.tree_specs(...)        -> each leaf's PartitionSpec, resolved as
                                       the reference resolves it
  * per device: the argument bytes by part (params, moments: the optimizer
    state, cache, inputs), each the sum of the leaves' local shard sizes;
    `fits_h100` on their sum (counted, not measured)
  * the roofline's compute term (model_flops split over the chips) and
    memory term (the device's argument bytes read once), chips = the mesh
    size.

A mesh case does not run the step: the per-device peak of live bytes and
the collective bytes are not counted there, and the record says so
(`"peak_counted": false`, `"collective_counted": false`) with no number.

Results land in benchmarks/results/dryrun_h100/<arch>__<shape>__<mesh>.json
(mesh: h100, single or multi).

Usage:
  python -m repro_torch.launch.dryrun --arch glm4-9b --shape train_4k
  python -m repro_torch.launch.dryrun --all
  python -m repro_torch.launch.dryrun --all --mesh both
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
import types
from typing import Dict, List, Optional, Sequence, Union

from .. import sharding as sh
from ..configs import get_config
from .cost_analysis import PARTS, analyze_case
from .mesh import MULTI, SINGLE, fake_process_group, make_production_mesh
from .roofline import H100, derive_roofline, model_flops
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
# card ("h100")
MESHES = {"single": SINGLE, "multi": MULTI}
MESH_ARGS = {"h100": ["h100"], "single": ["single"], "multi": ["multi"],
             "both": ["single", "multi"]}
MESH_PARTS = ("params", "moments", "cache", "inputs")


def _label(arch: str, shape_name: str, tag: str = "", mesh: str = "h100") -> str:
    return f"{arch}__{shape_name}__{mesh}" + (f"__{tag}" if tag else "")


def argument_bytes(case, mesh) -> Dict[str, int]:
    """One device's argument bytes by part (MESH_PARTS) when `case`'s
    arguments are laid out on `mesh` by their axes under the case's rules:
    each leaf's local shard, summed."""
    out = dict.fromkeys(MESH_PARTS, 0)
    with sh.use_mesh(mesh, case.rules):
        for part, arg, axes in zip(case.arg_parts, case.args, case.arg_axes):
            out[part] += sh.local_bytes(arg, axes)
    return out


def _mesh_record(case, mesh_name: str) -> dict:
    """A mesh case's per-device argument bytes and roofline terms (module
    docstring); nothing is run."""
    shape, names = MESHES[mesh_name]
    chips = math.prod(shape)
    with fake_process_group(chips):
        mesh = make_production_mesh(multi_pod=mesh_name == "multi", device_type="cpu")
        parts = argument_bytes(case, mesh)
    total = sum(parts.values())
    mf = model_flops(case.cfg, case.shape)
    roof = derive_roofline(types.SimpleNamespace(flops=mf / chips, dot_bytes=total,
                                                 collective_bytes=0.0),
                           case.cfg, case.shape, chips=chips, hw=H100).as_dict()
    # what a run of the step would count is not counted here: no number
    roof.update(collective_s=None, collective_bytes_device=None, counted_flops_device=None,
                dot_bytes_device=None, useful_ratio=None, step_s=None,
                flops_device=mf / chips, argument_bytes_device=total,
                dominant="compute" if roof["compute_s"] >= roof["memory_s"] else "memory")
    return {
        "mesh": dict(zip(names, shape)),
        "chips": chips,
        "rules": case.shape.kind,
        "memory": {**{f"{k}_gb": v / 1e9 for k, v in parts.items()},
                   "argument_gb": total / 1e9, "fits_h100": total <= H100.hbm_bytes,
                   "peak_counted": False},
        "collective_counted": False,
        "roofline": roof,
    }


def run_case(arch: str, shape: Union[str, ShapeSpec], out_dir: Optional[str] = OUT,
             tag: str = "", rt_kwargs: Optional[dict] = None, microbatches: int = 1,
             cfg_kwargs: Optional[dict] = None, mesh: str = "h100") -> dict:
    """One case's record (written to `out_dir` unless it is None), on one
    card ("h100") or on a production mesh (`MESHES`)."""
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
    try:
        case = build_case(arch, shape, rt_kwargs=rt_kwargs, microbatches=microbatches,
                          cfg_kwargs=cfg_kwargs)
        if mesh != "h100":
            rec = {"case": label, "status": "ok", "arch": arch, "shape": shape.name,
                   "seq": shape.seq, "batch": shape.batch, **_mesh_record(case, mesh),
                   "analyze_s": round(time.time() - t0, 2)}
            _write(out_dir, label, rec)
            return rec
        cost = analyze_case(case)
        roof = derive_roofline(cost, cfg, shape, chips=1, hw=H100)
        rec = {
            "case": label,
            "status": "ok",
            "arch": arch,
            "shape": shape.name,
            "seq": shape.seq,
            "batch": shape.batch,
            "chips": 1,
            "analyze_s": round(time.time() - t0, 2),
            "n_ops": cost.n_ops,
            "memory": {
                **{f"{k}_gb": v / 1e9 for k, v in cost.parts.items()},
                "peak_gb": cost.peak_bytes / 1e9,
                "fits_h100": cost.peak_bytes <= H100.hbm_bytes,
            },
            "cost": {"flops": cost.flops, "dot_bytes": cost.dot_bytes},
            "roofline": roof.as_dict(),
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
    """One line for a record: what fits, the peak and the dominant term."""
    if rec["status"] == "skipped":
        return f"{rec['case']}: SKIP ({rec['reason'].split(';')[0]})"
    if rec["status"] == "error":
        return f"{rec['case']}: ERROR {rec['error'][:200]}"
    m, r = rec["memory"], rec["roofline"]
    if "mesh" in rec:
        parts = " ".join(f"{k} {m[k + '_gb']:.3f}" for k in MESH_PARTS)
        return (f"{rec['case']}: OK {rec['chips']} chips {rec['rules']} rules, per device: "
                f"arguments {m['argument_gb']:.3f} GB ({parts}) fits_h100={m['fits_h100']} "
                f"(counted; peak and collectives not counted) terms(c/m)="
                f"{r['compute_s']:.4g}/{r['memory_s']:.4g}s dom={r['dominant']} "
                f"({rec['analyze_s']:.1f} s)")
    parts = " ".join(f"{k} {m[k + '_gb']:.2f}" for k in PARTS)
    return (f"{rec['case']}: OK peak {m['peak_gb']:.2f} GB ({parts}) fits_h100="
            f"{m['fits_h100']} flops {rec['cost']['flops']:.4g} terms(c/m)="
            f"{r['compute_s']:.4g}/{r['memory_s']:.4g}s dom={r['dominant']} useful="
            f"{r['useful_ratio']:.3f} ({rec['analyze_s']:.1f} s)")


def _work(arch: str, shape: ShapeSpec, mesh: str = "h100") -> int:
    """A rough count of the loop bodies a case dispatches, to start the
    longest first: each attention's chunk pairs (past naive_below keys; an
    enc-dec decoder layer attends twice, zamba2 once a group), each layer's
    sLSTM time steps, three passes to train."""
    cfg = get_config(arch)
    if mesh != "h100":  # arguments only
        return 0
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
    """Every case of `cases`, (arch, shape), (arch, shape, cfg_kwargs) or
    (arch, shape, cfg_kwargs, mesh) with a shape name or a ShapeSpec and
    "h100" (the default) or a name of MESHES, each in a process of a spawned pool
    of `workers` (default: one a core this process may run on) when there
    is more than one; records in the order of `cases`, each logged as it
    ends."""
    cases = [(c[0], SHAPES[c[1]] if isinstance(c[1], str) else c[1],
              c[2] if len(c) > 2 else None, c[3] if len(c) > 3 else "h100") for c in cases]
    workers = min(workers or len(os.sched_getaffinity(0)), len(cases))
    if workers <= 1:
        recs = []
        for arch, shape, cut, mesh in cases:
            recs.append(run_case(arch, shape, out_dir, cfg_kwargs=cut, mesh=mesh, **kw))
            logger.info("%s", case_line(recs[-1]))
        return recs
    ctx = multiprocessing.get_context("spawn")
    order = sorted(range(len(cases)), key=lambda i: -_work(cases[i][0], cases[i][1], cases[i][3]))
    with concurrent.futures.ProcessPoolExecutor(workers, mp_context=ctx) as pool:
        futs = {pool.submit(run_case, cases[i][0], cases[i][1], out_dir, cfg_kwargs=cases[i][2],
                            mesh=cases[i][3], **kw): i for i in order}
        recs: Dict[int, dict] = {}
        for f in concurrent.futures.as_completed(futs):
            recs[futs[f]] = f.result()
            logger.info("%s", case_line(recs[futs[f]]))
    return [recs[i] for i in range(len(cases))]


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    logging.basicConfig(level=logging.INFO, format="[dryrun] %(message)s")
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", default="h100", choices=list(MESH_ARGS),
                    help="one H100 (counts the step), or the production meshes (single: "
                         "16x16, multi: 2x16x16, both; counts the arguments)")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--tag", default="", help="variant tag for the JSON name")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--attention-impl", default=None)
    args = ap.parse_args(argv)

    rt_kwargs = {"attention_impl": args.attention_impl} if args.attention_impl else None
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
    recs = run_cases(cases, args.out, tag=args.tag, rt_kwargs=rt_kwargs,
                     microbatches=args.microbatches)
    n = {st: sum(r["status"] == st for r in recs) for st in ("ok", "skipped", "error")}
    logger.info("done: %d ok, %d skipped, %d errors", n["ok"], n["skipped"], n["error"])
    if n["error"]:
        raise SystemExit(1)
    return recs


if __name__ == "__main__":
    main()
