"""Content-addressed result cache: one file per (arm, rate, seed) point.

The port's copy of `repro/experiments/cache.py`. `code_fingerprint`
hashes the port's own engine sources, so a cache written by one package
reads as stale in the other: the two never share entries.

Every grid point of an experiment is an independent simulation fully
determined by its arm's physics configuration and the per-point
``(rate, seed)`` coordinates — the repo's fixed-seed bit-identity
contract. That makes results content-addressable: hash the part of the
spec that *determines the simulation output*, key the store on
``(arm_hash, rate, seed)``, and a warm rerun replays the stored
`PointRun` byte-identically (including its recorded ``duration_s`` and
``peak_rss_mb``, so re-serialized results match the cold run exactly).

Three hash layers:

  spec_hash(spec)      SHA-256 of the full canonical ``to_json()`` (the
                       whole-experiment identity the golden test pins)
  arm_fingerprint(arm) SHA-256 of one resolved arm's *result-relevant*
                       identity: workload/system/control/faults plus the
                       sweep fields that alter a point's physics
                       (sim_time, warmup, base_seed, window_s, fast).
                       Grid shape (rates, n_seeds) lives in the key, not
                       the hash; post-processing (alpha) and execution
                       knobs (workers, task_timeout_s) are excluded —
                       identical arms under different grids share entries
  code_fingerprint()   SHA-256 over the simulation-engine sources
                       (``repro_torch.{core,network,batching,control,faults}``)

Invalidation is by *staleness*, not key: entries store the
``SCHEMA_VERSION`` and code fingerprint they were produced under, and a
mismatch on read counts as ``stale`` (distinct from ``miss`` in the
accounting) — the entry is then overwritten by the fresh result. The
telemetry/experiments layers are deliberately outside the fingerprint:
the repo's bit-identity gates prove they observe without perturbing.

Writes are atomic (tmp file + ``os.replace``) so a killed run never
leaves a torn entry, and concurrent writers of the same point simply
race to publish identical bytes.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
from functools import lru_cache
from typing import Optional

from ..core.simulator import SimResult
from .result import PointRun
from .spec import SCHEMA_VERSION, ExperimentSpec, ResolvedArm, _encode

__all__ = [
    "CACHE_SCHEMA",
    "CacheStats",
    "ResultCache",
    "arm_fingerprint",
    "code_fingerprint",
    "spec_hash",
]

# bump when the cache entry layout changes; old entries then read as stale
CACHE_SCHEMA = 1

# engine packages whose sources define what a simulation computes; the
# observation/orchestration layers (telemetry, experiments) are excluded
# because the repo's bit-identity gates prove they never perturb results
_ENGINE_PACKAGES = ("core", "network", "batching", "control", "faults")


def _canonical_json(obj) -> str:
    return json.dumps(obj, indent=1, sort_keys=True)


def _sha256(text: str) -> str:
    return hashlib.sha256(text.encode("utf-8")).hexdigest()


def spec_hash(spec: ExperimentSpec) -> str:
    """Content hash of a whole experiment: SHA-256 over the canonical
    sorted-key ``to_json()`` emission (which embeds `SCHEMA_VERSION`, so
    a schema bump re-hashes every spec loudly). Stable across dict
    ordering and process restarts; changes when any spec field changes —
    equal to the reference's for every registered experiment
    (tests/test_torch_experiments.py)."""
    return _sha256(spec.to_json())


# sweep fields that change what one grid point *computes* (the rest are
# grid shape, post-processing, or execution knobs — see module docstring)
_ARM_SWEEP_FIELDS = ("sim_time", "warmup", "base_seed", "window_s", "fast")


def arm_fingerprint(arm: ResolvedArm) -> str:
    """Content hash of one resolved arm's result-relevant identity (the
    cache directory key). Excludes the arm *name* on purpose: two arms
    with identical physics share entries."""
    ident = {
        "schema_version": SCHEMA_VERSION,
        "workload": _encode(arm.workload),
        "system": _encode(arm.system),
        "control": _encode(arm.control),
        "faults": _encode(arm.faults),
        "sweep": {f: getattr(arm.sweep, f) for f in _ARM_SWEEP_FIELDS},
    }
    return _sha256(_canonical_json(ident))


@lru_cache(maxsize=1)
def code_fingerprint() -> str:
    """SHA-256 over the engine sources (sorted relpath + contents of
    every ``.py`` under `_ENGINE_PACKAGES`). Any engine edit changes it,
    so cached results produced by different simulation code read as
    stale instead of silently replaying."""
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    h = hashlib.sha256()
    for pkg in _ENGINE_PACKAGES:
        base = os.path.join(pkg_root, pkg)
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames.sort()
            for fn in sorted(filenames):
                if not fn.endswith(".py"):
                    continue
                path = os.path.join(dirpath, fn)
                rel = os.path.relpath(path, pkg_root)
                h.update(rel.encode("utf-8"))
                h.update(b"\x00")
                with open(path, "rb") as f:
                    h.update(f.read())
                h.update(b"\x00")
    return h.hexdigest()


@dataclasses.dataclass
class CacheStats:
    """Lookup/write accounting for one `ResultCache` (cumulative across
    runs sharing the instance; `repro_torch.experiments.dispatch.run_sharded`
    snapshots before/after to report per-run deltas)."""

    hits: int = 0
    misses: int = 0
    stale: int = 0
    writes: int = 0

    def as_dict(self) -> dict:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "stale": self.stale,
            "writes": self.writes,
        }


class ResultCache:
    """File-backed store of computed grid points.

    Layout: ``<root>/<arm_fingerprint>/r<rate>_s<seed>.json`` — one JSON
    file per point, carrying the entry metadata (cache schema, spec
    schema version, code fingerprint) and the serialized `PointRun`
    (SimResult fields, extras, duration, peak RSS). Rates are keyed by
    ``repr(float(rate))``, which is injective on floats.
    """

    def __init__(self, root: str):
        self.root = os.fspath(root)
        os.makedirs(self.root, exist_ok=True)
        self.stats = CacheStats()

    # ------------------------------------------------------------ paths
    def entry_path(self, arm: ResolvedArm, rate: float, seed_idx: int) -> str:
        return os.path.join(
            self.root, arm_fingerprint(arm),
            f"r{float(rate)!r}_s{int(seed_idx)}.json",
        )

    # ----------------------------------------------------------- lookup
    def get(self, arm: ResolvedArm, rate: float,
            seed_idx: int) -> Optional[PointRun]:
        """Return the cached `PointRun` for one grid point, or None.

        A structurally valid entry produced under a different cache
        schema, spec `SCHEMA_VERSION`, or engine `code_fingerprint`
        counts as *stale* (not a miss) and is not returned — the caller
        recomputes and `put` overwrites it. An unreadable/torn entry
        also reads as stale: it exists but cannot be trusted.
        """
        path = self.entry_path(arm, rate, seed_idx)
        if not os.path.exists(path):
            self.stats.misses += 1
            return None
        try:
            with open(path, encoding="utf-8") as f:
                doc = json.load(f)
            meta = doc["meta"]
            fresh = (
                meta.get("cache_schema") == CACHE_SCHEMA
                and meta.get("schema_version") == SCHEMA_VERSION
                and meta.get("code_fingerprint") == code_fingerprint()
            )
            if not fresh:
                self.stats.stale += 1
                return None
            pr = PointRun(
                result=SimResult(**doc["result"]),
                extras=dict(doc.get("extras", {})),
                duration_s=doc.get("duration_s", 0.0),
                peak_rss_mb=doc.get("peak_rss_mb"),
                cached=True,
            )
        except (OSError, ValueError, KeyError, TypeError):
            self.stats.stale += 1
            return None
        self.stats.hits += 1
        return pr

    # ------------------------------------------------------------ store
    def put(self, arm: ResolvedArm, rate: float, seed_idx: int,
            pr: PointRun) -> bool:
        """Store one computed point; returns True when written.

        Errored points are never cached (an error is a property of the
        run, not the spec), and neither are points carrying telemetry or
        profile attachments — those are runtime observations whose blobs
        don't belong in a content-addressed result store.
        """
        if pr.result is None or pr.error is not None:
            return False
        if pr.result.telemetry is not None or pr.result.profile is not None:
            return False
        doc = {
            "meta": {
                "cache_schema": CACHE_SCHEMA,
                "schema_version": SCHEMA_VERSION,
                "code_fingerprint": code_fingerprint(),
                "arm_fingerprint": arm_fingerprint(arm),
                # informational only (the fingerprint is the identity):
                # which arm/point first published this entry
                "arm": arm.name,
                "rate": float(rate),
                "seed": int(seed_idx),
            },
            "result": dataclasses.asdict(pr.result),
            "extras": dict(pr.extras),
            "duration_s": pr.duration_s,
            **({"peak_rss_mb": pr.peak_rss_mb}
               if pr.peak_rss_mb is not None else {}),
        }
        path = self.entry_path(arm, rate, seed_idx)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        # atomic publish: a killed run never leaves a torn entry, and
        # same-point racers overwrite each other with identical bytes
        fd, tmp = tempfile.mkstemp(
            dir=os.path.dirname(path), suffix=".tmp"
        )
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                f.write(_canonical_json(doc))
            os.replace(tmp, path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        self.stats.writes += 1
        return True
