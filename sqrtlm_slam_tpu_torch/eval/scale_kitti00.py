"""Loop correction at KITTI 00's scale: `benchmarks/bench_scale.py`'s flow
at 1,400 keyframes and 280,000 landmarks, and the gates that hold a run of
it against the JAX package's CPU record.

The flow (`FLOW`): `eval/scale.py::make_scale_store` (the 80 m ring, drift
4e-4, 5 observations a landmark in 7 slots), the true loop edge from the
last keyframe to the first through the essential graph (`edge_cap` 16384,
30 Gauss-Newton iterations), then `LoopCloser.run_global_ba` for 10 LM
iterations in one chunk. 280,000 landmarks at 1,400 keyframes is the 600 x
120,000 configuration's density (200 new landmarks a keyframe, ~1,000
observations a keyframe, as a 2,000-feature ORB-SLAM2 keyframe on KITTI
tracks). The record, `scale_kitti00_jax.json` beside this file, is the JAX
package's run of the same flow on the CPU (`scripts/scale_reference.py
--package jax`); `chip_smoke.py` phase 22 drives the port on the card and
`gates` holds it against the record.

`chip_smoke.py` phase 23 runs distributed BA (`dist_ba.make_bucketed_lm_
iterate`, 4, 2 and 1 shards on one card) and the flat engine's global BA
(`schur.global_ba_cg`) on the flow's store after the essential graph;
`dist_gates` holds such a run against the card's record of it
(`scale_kitti00_dist.json` beside this file, `DIST_RECORD`).

Imports no JAX: `pose_graph_of_loop` takes the package's loop closer and
a Sim3 constructor, so the JAX package's runs build the same graph.
"""

from __future__ import annotations

import json
import os

from types import SimpleNamespace

import numpy as np

from .scale import store_ate

RECORD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scale_kitti00_jax.json")
DIST_RECORD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scale_kitti00_dist.json")

FLOW = dict(kfs=1400, lms=280_000, obs_per_lm=5, drift=4e-4, edge_cap=16384, eg_iters=30,
            gba_iters=10, gba_chunk=10)

# Both packages build the store from the same numpy draws: the drift ATE
# agrees to float64 rounding of the alignment.
DRIFT_TOL_M = 1e-6
# The stages held within the float32 spread (`tolerances`).
STAGES = ("ate_after_loop_m", "ate_after_gba_m", "chi2_after")
# The essential graph in float64 against the JAX package's float64 answer:
# the two packages' answers part by 1.34e-5 m (their edge measurements,
# composed in float32, differ by up to one float32 ulp of the 64-128 m
# world coordinates), the port's on the card and on the CPU not at all;
# float32 runs of either lie 2.0-5.9 mm from it (PERF.md section 7).
F64_TOL_M = 5e-5

SIZES = ("kfs", "landmarks", "edges", "essential_graph_edges")


def load_record(path: str = RECORD) -> dict:
    with open(path) as f:
        return json.load(f)


def pose_graph_of_loop(lc, true_R: np.ndarray, true_t: np.ndarray, make_sim3):
    """The essential graph of the true loop edge (the true relative pose
    from the first keyframe to the last, T_cw) over every keyframe of
    `lc`'s store, initial values and measurements the store's poses, as
    `benchmarks/bench_scale.py` builds it. `make_sim3(R, t)` is the
    package's Sim3 of scale 1."""
    store = lc.store
    K = store.num_kf
    R = true_R[K - 1] @ true_R[0].T
    t = true_t[K - 1] - R @ true_t[0]
    ones = np.ones(K, np.float32)
    return lc._build_pose_graph(K - 1, 0, make_sim3(R, t), ones,
                                store.kf_R[:K].copy(), store.kf_t[:K].copy(), ones.copy(),
                                store.kf_R[:K].copy(), store.kf_t[:K].copy())


def poses_ate(s, R, t, true_R: np.ndarray, true_t: np.ndarray) -> float:
    """The store's ATE had the pose graph's (s, R, t) been written back
    (`LoopCloser._apply_pose_graph`: R, t / s in float32)."""
    s, R, t = (np.asarray(x, np.float64) for x in (s, R, t))
    kf_t = (t / np.maximum(s, 1e-9)[:, None]).astype(np.float32)
    return store_ate(SimpleNamespace(num_kf=len(s), kf_R=R.astype(np.float32), kf_t=kf_t),
                     true_R, true_t)


def float64_answer(record: dict, package: str = "jax") -> float:
    """The ATE after the flow's essential graph solved in float64 by
    `package` (`float64_runs` of the record)."""
    steps = str(record["eg_iters"])
    return next(r["ate_m_after_steps"][steps] for r in record["float64_runs"]
                if r["package"] == package)


def tolerances(record: dict) -> dict:
    """How far a float32 run may lie from the record: the spread (largest
    less smallest) of each stage over the record and its `float32_draws`,
    the other float32 runs of either package on the CPU with a rounding-
    level change (`scripts/scale_reference.py --merge-draws`: the port at
    several thread counts, either package's store scaled by 1 + k 2^-23).
    Within its 30 damped Gauss-Newton steps the essential graph at 1,400
    keyframes has not converged (in float64 the ATE still falls 3.2 cm from
    30 to 100 steps), and the order of a float32 solve's operations moves
    where it stops by millimetres (PERF.md section 7). chi2 after GBA:
    relative to the record's."""
    runs = [record] + list(record.get("float32_draws", []))
    tol = {}
    for k in STAGES:
        vals = [r[k] for r in runs]
        tol[k] = max(vals) - min(vals)
    tol["chi2_after_rel"] = tol.pop("chi2_after") / record["chi2_after"]
    return tol


def gates(run: dict, record: dict, tol: dict | None = None) -> list:
    """The failures of `run` against `record` (both with the keys of the
    record: sizes, `ate_drift_m`, `ate_after_loop_m`, `ate_after_gba_m`,
    `chi2_before`, `chi2_after`, `gba_completed`; where `run` has
    `ate_after_loop_f64_m`, its essential graph solved in float64, that
    within F64_TOL_M of the JAX package's float64 answer) within `tol`
    (default `tolerances(record)`); empty when it passes."""
    tol = tolerances(record) if tol is None else tol
    bad = []
    for k in SIZES:
        if run[k] != record[k]:
            bad.append(f"{k} {run[k]} != {record[k]}")
    if not abs(run["ate_drift_m"] - record["ate_drift_m"]) <= DRIFT_TOL_M:
        bad.append(f"drift ATE {run['ate_drift_m']} m not within {DRIFT_TOL_M} m of "
                   f"{record['ate_drift_m']}")
    if "ate_after_loop_f64_m" in run:
        want = float64_answer(record)
        if not abs(run["ate_after_loop_f64_m"] - want) <= F64_TOL_M:
            bad.append(f"the essential graph in float64: ATE {run['ate_after_loop_f64_m']} m "
                       f"not within {F64_TOL_M} m of the JAX package's {want}")
    for k in ("ate_after_loop_m", "ate_after_gba_m"):
        if not abs(run[k] - record[k]) <= tol[k]:
            bad.append(f"{k} {run[k]} not within {tol[k]} m of {record[k]}")
    rel = abs(run["chi2_after"] / record["chi2_after"] - 1.0)
    if not rel <= tol["chi2_after_rel"]:
        bad.append(f"chi2 after GBA {run['chi2_after']} not within {tol['chi2_after_rel']} "
                   f"of {record['chi2_after']} (relative {rel})")
    if not run["chi2_after"] < run["chi2_before"]:
        bad.append(f"chi2 did not fall: {run['chi2_before']} -> {run['chi2_after']}")
    if not run["gba_completed"]:
        bad.append("global BA did not complete")
    return bad


# -- phase 23: distributed BA and the flat engine's global BA ----------------

# Shard counts of distributed BA on one card, in the order they run, and
# the rescalings 1 + k 2^-23 of the store's keyframe translations and
# landmark positions of the float32 draws beside k = 0
# (`scripts/scale_reference.py --jitter-ulps`): at one shard for
# distributed BA, and for the flat GBA.
DIST_SHARDS = (4, 2, 1)
DIST_JITTER_ULPS = (-1, 1)
DIST_RECORD_JITTER_ULPS = (-3, -2, -1, 1, 2, 3)  # the record's draws
# Each shard's S_half and rhs_corr of the first LM iteration at 4 shards
# against the dense one-hot formula (the JAX package's math in float32):
# the largest difference over the largest entry of the dense formula's.
DIST_DENSE_REL_TOL = 5e-6
# The memory a run keeps once its graphs are dropped, over the reading
# before it (below it where its captures evicted an earlier phase's of the
# same programs), and one shard's peak allocated memory.
DIST_KEPT_MARGIN_MB = 64.0
DIST_ONE_SHARD_MAX_MB = 16 * 1024


def load_dist_record(path: str = DIST_RECORD) -> dict:
    with open(path) as f:
        return json.load(f)


def _spread(vals) -> float:
    return max(vals) - min(vals)


def dist_tolerances(run: dict, record: dict) -> dict:
    """The float32 spread that phase 23's outcomes are held within: the
    largest less the smallest ATE, and chi2 (relative to the smallest),
    over the float32 draws of the run and of the record (the store rescaled
    by 1 + k 2^-23): at one shard for distributed BA (`draws`), the flat
    GBA's (`flat.draws`)."""
    tol = {}
    for name, draws in (("dist", run["draws"] + record["draws"]),
                        ("flat", run["flat"]["draws"] + record["flat"]["draws"])):
        chi2 = [d["chi2"] for d in draws]
        tol[f"{name}_ate_m"] = _spread([d["ate_m"] for d in draws])
        tol[f"{name}_chi2_rel"] = _spread(chi2) / min(chi2)
    return tol


def _within(bad: list, what: str, got: dict, want: dict, tol: dict, name: str) -> None:
    """Append a failure where `got`'s ATE or chi2 lies outside `tol` (the
    `name` stage's spread) of `want`'s."""
    if not abs(got["ate_m"] - want["ate_m"]) <= tol[f"{name}_ate_m"]:
        bad.append(f"{what}: ATE {got['ate_m']} m not within {tol[f'{name}_ate_m']} m of "
                   f"{want['ate_m']}")
    rel = abs(got["chi2"] / want["chi2"] - 1.0)
    if not rel <= tol[f"{name}_chi2_rel"]:
        bad.append(f"{what}: chi2 {got['chi2']} not within {tol[f'{name}_chi2_rel']} of "
                   f"{want['chi2']} (relative {rel})")


def dist_gates(run: dict, record: dict, tol: dict | None = None) -> list:
    """The failures of phase 23's `run` against `record` (both with the keys
    of the record); empty when it passes. Distributed BA at each shard
    count: graphed, replayed and eager bitwise equal, chi2 falls, at least
    one LM iteration accepted, the ATE no worse than after the essential
    graph, no more than DIST_KEPT_MARGIN_MB kept once the graph is dropped,
    the ATE and chi2 within the spread (`dist_tolerances`) of one
    shard's; one shard completes under DIST_ONE_SHARD_MAX_MB, within the
    spread of the record's; (b) every shard's S_half and rhs_corr within
    DIST_DENSE_REL_TOL of the dense formula's. The flat GBA: bitwise three
    ways, chi2 falls, the ATE no worse than after the essential graph, the
    memory given back, within the spread of the record's."""
    tol = dist_tolerances(run, record) if tol is None else tol
    bad = []
    shards = run["shards"]
    one = shards.get("1")
    if one is None or not one["completed"]:
        bad.append("distributed BA at 1 shard did not complete")
    else:
        if not one["max_allocated_mb"] < DIST_ONE_SHARD_MAX_MB:
            bad.append(f"1 shard's peak allocated {one['max_allocated_mb']} MB")
        _within(bad, "1 shard against the record", one, record["shards"]["1"], tol, "dist")
    for d, r in shards.items():
        where = f"{d} shard(s)"
        if not r["bitwise_equal"]:
            bad.append(f"{where}: graphed, replayed and eager differ")
        if not r["accepted"] >= 1:
            bad.append(f"{where}: no LM iteration accepted")
        if not r["chi2"] < run["chi2_before"]:
            bad.append(f"{where}: chi2 did not fall: {run['chi2_before']} -> {r['chi2']}")
        if not r["ate_m"] <= run["ate_after_loop_m"]:
            bad.append(f"{where}: ATE {r['ate_m']} m worse than after the essential graph "
                       f"({run['ate_after_loop_m']})")
        if not r["kept_mb_dropped"] <= DIST_KEPT_MARGIN_MB:
            bad.append(f"{where}: {r['kept_mb_dropped']} MB kept after the graph was dropped")
        if one is not None and d != "1":
            _within(bad, f"{where} against 1 shard", r, one, tol, "dist")
    for k in ("S_rel", "rhs_rel"):
        worst = max(run["dense"][k])
        if not worst <= DIST_DENSE_REL_TOL:
            bad.append(f"(b) {k} {worst} against the dense formula, past {DIST_DENSE_REL_TOL}")
    flat = run["flat"]
    if not flat["bitwise_equal"]:
        bad.append("flat GBA: graphed, replayed and eager differ")
    if not flat["chi2"] < flat["chi2_before"]:
        bad.append(f"flat GBA: chi2 did not fall: {flat['chi2_before']} -> {flat['chi2']}")
    if not flat["ate_m"] <= run["ate_after_loop_m"]:
        bad.append(f"flat GBA: ATE {flat['ate_m']} m worse than after the essential graph "
                   f"({run['ate_after_loop_m']})")
    if not flat["kept_mb_dropped"] <= DIST_KEPT_MARGIN_MB:
        bad.append(f"flat GBA: {flat['kept_mb_dropped']} MB kept after its graphs were dropped")
    _within(bad, "flat GBA against the record", flat, record["flat"], tol, "flat")
    return bad
