"""The loop correction at KITTI 00's scale (`eval/scale_kitti00.py`,
`chip_smoke.py` phases 22 and 23) on the CPU: a superseded global BA in
both packages, the gates that hold a run against the JAX package's record,
phase 23's gates against the card's record of distributed BA and the flat
GBA, and (`-m slow`) the two packages' flow at 1,400 keyframes.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqrtlm_slam_tpu.eval import scale as j_scale
from sqrtlm_slam_tpu.eval.synthetic import DEFAULT_CAM
from sqrtlm_slam_tpu.geometry import sim3 as j_sim3
from sqrtlm_slam_tpu.loop import closing as j_closing
from sqrtlm_slam_tpu.loop import essential_graph as j_eg
from sqrtlm_slam_tpu.optim import schur_bucketed as j_schur
from sqrtlm_slam_tpu_torch import convert
from sqrtlm_slam_tpu_torch.eval import scale as t_scale
from sqrtlm_slam_tpu_torch.eval import scale_kitti00
from sqrtlm_slam_tpu_torch.geometry import sim3 as t_sim3
from sqrtlm_slam_tpu_torch.loop import closing as t_closing
from sqrtlm_slam_tpu_torch.loop import essential_graph as t_eg
from sqrtlm_slam_tpu_torch.optim import schur_bucketed as t_schur

CAM = convert.camera(DEFAULT_CAM)
FIELDS = ("kf_R", "kf_t", "lm_pos", "lm_obs_kf", "lm_obs_idx", "lm_valid", "kf_obs_lm")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


class Package:
    """One package's scale store, loop closer, essential graph and chi2."""

    def __init__(self, name):
        self.name = name
        if name == "jax":
            self.make_store = j_scale.make_scale_store
            self.closer = lambda store, cfg: j_closing.LoopCloser(store, DEFAULT_CAM, cfg=cfg)
            self.sim3 = lambda R, t: j_sim3.Sim3(jnp.asarray(1.0), jnp.asarray(R),
                                                 jnp.asarray(t))
            self.optimize = j_eg.optimize_pose_graph
            self.chi2 = lambda s: float(j_schur.chi2_only(
                p := j_closing.gather_global_problem_bucketed(s)[0], DEFAULT_CAM, p.obs_valid,
                None))
        else:
            self.make_store = t_scale.make_scale_store
            self.closer = lambda store, cfg: t_closing.LoopCloser(store, CAM, cfg=cfg,
                                                                  device="cpu")
            self.sim3 = lambda R, t: t_sim3.Sim3(torch.tensor(1.0), torch.as_tensor(R),
                                                 torch.as_tensor(t))
            self.optimize = t_eg.optimize_pose_graph
            self.chi2 = lambda s: float(t_schur.chi2_only(
                p := t_closing.gather_global_problem_bucketed(s, "cpu")[0], CAM, p.obs_valid,
                None))


# 48 keyframes on a ring of the 1,400-keyframe ring's step (80 m x 48 / 1400):
# on the 80 m ring each keyframe turns 7.5 degrees and moves 10 m, a landmark
# 6-30 m ahead of its home keyframe lies behind the fourth keyframe after,
# and both packages' GBA rejects the map (fewer than half the observations
# survive) instead of running to its end.
SMALL = dict(n_kf=48, n_lm=1000, obs_per_lm=5, drift=4e-4, radius=80.0 * 48 / 1400)


def superseded_then_completed(pkg: Package):
    """A GBA whose generation is bumped from `_gba_tick` after its first
    chunk, then one that runs to its end on the same store: (superseded
    run's return, aborts, the store's fields before and after it, the
    second's return, the ATE before and after it)."""
    store, tR, tt = pkg.make_store(**SMALL)
    lc = pkg.closer(store, pkg_cfg(pkg))

    def supersede():
        lc.gba_generation += 1
        lc._gba_tick = lambda: None

    lc._gba_tick = supersede
    before = {f: getattr(store, f).copy() for f in FIELDS}
    ok = lc.run_global_ba()
    after = {f: getattr(store, f).copy() for f in FIELDS}
    aborted = lc.num_gba_aborted
    ate0 = t_scale.store_ate(store, tR, tt)
    ok2 = lc.run_global_ba()
    return ok, aborted, before, after, ok2, ate0, t_scale.store_ate(store, tR, tt), \
        lc.num_gba_completed


def pkg_cfg(pkg: Package, **kw):
    mod = j_closing if pkg.name == "jax" else t_closing
    return mod.LoopClosingConfig(**(kw or dict(gba_iters=2, gba_chunk=1)))


def test_superseded_gba_leaves_the_store_in_both_packages():
    """Each package's superseded GBA returns False, counts one abort and
    leaves the store bitwise as it was; the GBA that follows completes in
    both, and their ATEs after it agree within 1e-3 m (the reduced-scale
    test's tolerance)."""
    out = {name: superseded_then_completed(Package(name)) for name in ("torch", "jax")}
    for name, (ok, aborted, before, after, ok2, ate0, ate1, done) in out.items():
        assert ok is False and aborted == 1, name
        for f in FIELDS:
            np.testing.assert_array_equal(after[f], before[f], err_msg=f"{name} {f}")
        assert ok2 is True and done == 1, name
        assert ate1 < ate0, (name, ate0, ate1)
    np.testing.assert_allclose(out["torch"][6], out["jax"][6], atol=1e-3)


# -- phase 22's gates ----------------------------------------------------------


def test_gates_accept_the_record_itself():
    record = scale_kitti00.load_record()
    assert record["package"] == "jax"
    for k, v in scale_kitti00.FLOW.items():
        if k in record:
            assert record[k] == v, k
    assert record["landmarks"] == scale_kitti00.FLOW["lms"]
    assert scale_kitti00.gates(record, record) == []
    f64 = scale_kitti00.float64_answer(record)
    assert scale_kitti00.gates(dict(record, ate_after_loop_f64_m=f64), record) == []


def test_tolerances_are_the_spread_of_the_float32_runs():
    """Each tolerance is the largest less the smallest value of its stage
    over the record and its float32 draws (both packages, the CPU and the
    card), chi2's relative to the record's."""
    record = scale_kitti00.load_record()
    draws = record["float32_draws"]
    assert {d["package"] for d in draws} == {"jax", "port"}
    assert {d["device"] for d in draws if d["package"] == "port"} == {"cpu", "cuda"}
    tol = scale_kitti00.tolerances(record)
    for k in ("ate_after_loop_m", "ate_after_gba_m"):
        vals = [record[k]] + [d[k] for d in draws]
        assert tol[k] == max(vals) - min(vals) > 0
    chi2 = [record["chi2_after"]] + [d["chi2_after"] for d in draws]
    assert tol["chi2_after_rel"] == (max(chi2) - min(chi2)) / record["chi2_after"]


@pytest.mark.parametrize("stage", ["ate_after_loop_m", "ate_after_gba_m"])
@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_gates_reject_a_stage_just_past_its_tolerance(stage, sign):
    record = scale_kitti00.load_record()
    tol = scale_kitti00.tolerances(record)[stage]
    assert tol > 0
    inside = dict(record, **{stage: record[stage] + sign * 0.99 * tol})
    assert scale_kitti00.gates(inside, record) == []
    past = dict(record, **{stage: record[stage] + sign * 1.01 * tol})
    assert [stage in f for f in scale_kitti00.gates(past, record)] == [True]


def test_gates_reject_float64_drift_chi2_and_an_unfinished_gba():
    record = scale_kitti00.load_record()
    g = scale_kitti00.gates
    assert len(g(dict(record, ate_drift_m=record["ate_drift_m"] + 2e-6), record)) == 1
    assert len(g(dict(record, chi2_before=record["chi2_after"]), record)) == 1  # no fall
    tol = scale_kitti00.tolerances(record)["chi2_after_rel"]
    assert len(g(dict(record, chi2_after=record["chi2_after"] * (1 + 1.01 * tol)), record)) == 1
    assert g(dict(record, chi2_after=record["chi2_after"] * (1 - 0.99 * tol)), record) == []
    assert len(g(dict(record, gba_completed=False), record)) == 1
    assert len(g(dict(record, edges=record["edges"] - 1), record)) == 1
    f64, tol64 = scale_kitti00.float64_answer(record), scale_kitti00.F64_TOL_M
    for sign in (1.0, -1.0):
        assert g(dict(record, ate_after_loop_f64_m=f64 + sign * 0.99 * tol64), record) == []
        assert len(g(dict(record, ate_after_loop_f64_m=f64 + sign * 1.01 * tol64),
                     record)) == 1


# -- phase 23's gates: distributed BA and the flat GBA -------------------------


def test_dist_gates_accept_the_record_itself():
    rec = scale_kitti00.load_dist_record()
    assert (rec["kfs"], rec["landmarks"], rec["gba_iters"]) == (
        scale_kitti00.FLOW["kfs"], scale_kitti00.FLOW["lms"], scale_kitti00.FLOW["gba_iters"])
    assert sorted(rec["shards"], key=int, reverse=True) == [
        str(d) for d in scale_kitti00.DIST_SHARDS]
    for draws in (rec["draws"], rec["flat"]["draws"]):
        assert {-1, 0, 1} <= {d["k"] for d in draws}
    assert scale_kitti00.dist_gates(rec, rec) == []


def test_dist_tolerances_are_the_spread_of_the_draws():
    """The shard counts are held within the spread of one shard's float32
    draws, the flat GBA within its own draws' (the run's and the
    record's); chi2's relative to the smallest."""
    rec = scale_kitti00.load_dist_record()
    tol = scale_kitti00.dist_tolerances(rec, rec)
    for name, draws in (("dist", rec["draws"]), ("flat", rec["flat"]["draws"])):
        ate = [d["ate_m"] for d in draws]
        chi2 = [d["chi2"] for d in draws]
        assert tol[f"{name}_ate_m"] == max(ate) - min(ate) > 0
        assert tol[f"{name}_chi2_rel"] == (max(chi2) - min(chi2)) / min(chi2)


@pytest.mark.parametrize("stage", ["ate_m", "chi2"])
@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_dist_gates_reject_a_stage_just_past_its_tolerance(stage, sign):
    """A shard count whose ATE or chi2 lies just past the spread of one
    shard's draws fails, one just inside passes; so does the flat GBA
    against the record's."""
    rec = scale_kitti00.load_dist_record()
    tol = scale_kitti00.dist_tolerances(rec, rec)
    for name in ("dist", "flat"):
        t = tol[f"{name}_ate_m"] if stage == "ate_m" else tol[f"{name}_chi2_rel"]
        assert t > 0
        for factor, fails in ((0.99, False), (1.01, True)):
            run = copy.deepcopy(rec)
            if name == "dist":
                ref = rec["shards"]["1"][stage]
                moved = run["shards"]["4"]
            else:
                ref = rec["flat"][stage]
                moved = run["flat"]
            step = factor * t * (1.0 if stage == "ate_m" else ref)
            moved[stage] = ref + sign * step
            bad = scale_kitti00.dist_gates(run, rec, tol)
            where = "4 shard(s)" if name == "dist" else "flat GBA"
            assert [where in f and ("ATE" if stage == "ate_m" else "chi2") in f
                    for f in bad] == ([True] if fails else []), (name, factor, bad)


def test_dist_gates_reject_what_the_phase_must_not_do():
    rec = scale_kitti00.load_dist_record()
    g = scale_kitti00.dist_gates

    def changed(edit):
        run = copy.deepcopy(rec)
        edit(run)
        return g(run, rec)

    for d in rec["shards"]:
        assert len(changed(lambda r: r["shards"][d].update(bitwise_equal=False))) == 1
        assert len(changed(lambda r: r["shards"][d].update(accepted=0))) == 1
        assert len(changed(lambda r: r["shards"][d].update(
            kept_mb_dropped=1.01 * scale_kitti00.DIST_KEPT_MARGIN_MB))) == 1
    assert changed(lambda r: r["shards"]["2"].update(
        kept_mb_dropped=0.99 * scale_kitti00.DIST_KEPT_MARGIN_MB)) == []
    # Below the reading before: the run's captures evicted an earlier
    # phase's of the same programs (the whole smoke: -166 MB for the flat GBA).
    assert changed(lambda r: r["flat"].update(kept_mb_dropped=-166.0)) == []
    assert len(changed(lambda r: r["shards"]["1"].update(completed=False))) == 1
    assert len(changed(lambda r: r["shards"]["1"].update(
        max_allocated_mb=scale_kitti00.DIST_ONE_SHARD_MAX_MB))) == 1
    assert len(changed(lambda r: r["dense"]["S_rel"].append(
        1.01 * scale_kitti00.DIST_DENSE_REL_TOL))) == 1
    assert len(changed(lambda r: r["dense"]["rhs_rel"].append(
        1.01 * scale_kitti00.DIST_DENSE_REL_TOL))) == 1
    assert len(changed(lambda r: r.update(chi2_before=r["shards"]["4"]["chi2"]))) >= 1
    assert len(changed(lambda r: r["flat"].update(chi2_before=r["flat"]["chi2"]))) == 1
    assert len(changed(lambda r: r["flat"].update(bitwise_equal=False))) == 1
    assert len(changed(lambda r: r.update(ate_after_loop_m=0.0))) == len(rec["shards"]) + 1


# -- the flow at KITTI 00's keyframe count ------------------------------------


def close_the_loop(pkg: Package, n_kf: int, n_lm: int, gba_iters: int) -> dict:
    """bench_scale.py's flow (`scale_kitti00.FLOW` but for the sizes and the
    LM iterations): a run dict with the record's keys."""
    flow = scale_kitti00.FLOW
    store, tR, tt = pkg.make_store(n_kf=n_kf, n_lm=n_lm, obs_per_lm=flow["obs_per_lm"],
                                   drift=flow["drift"])
    lc = pkg.closer(store, pkg_cfg(pkg, edge_cap=flow["edge_cap"], gba_iters=gba_iters,
                                   gba_chunk=gba_iters))
    run = dict(kfs=n_kf, landmarks=n_lm, ate_drift_m=t_scale.store_ate(store, tR, tt))
    pg = scale_kitti00.pose_graph_of_loop(lc, tR, tt, pkg.sim3)
    run["essential_graph_edges"] = int(np.asarray(pg.e_valid).sum())
    out, _ = pkg.optimize(pg, num_iters=flow["eg_iters"])
    lc._apply_pose_graph(out, n_kf)
    run["ate_after_loop_m"] = t_scale.store_ate(store, tR, tt)
    run["chi2_before"] = pkg.chi2(store)
    run["edges"] = int((store.lm_obs_kf[:n_lm] >= 0).sum())
    run["gba_completed"] = bool(lc.run_global_ba())
    run["chi2_after"] = pkg.chi2(store)
    run["ate_after_gba_m"] = t_scale.store_ate(store, tR, tt)
    return run


@pytest.mark.slow
def test_the_flow_at_kitti00_keyframes_in_both_packages():
    """1,400 keyframes x 60,000 landmarks, 2 LM iterations of GBA (the
    first comparison's configuration): the port's run passes phase 22's
    gates with the JAX package's run as the record (sizes equal, the drift
    ATE within 1e-6 m, the ATE after each stage and chi2 after GBA within
    `scale_kitti00.tolerances` of the record, chi2 falls, GBA completes)."""
    tol = scale_kitti00.tolerances(scale_kitti00.load_record())
    runs = {name: close_the_loop(Package(name), 1400, 60_000, 2) for name in ("torch", "jax")}
    assert scale_kitti00.gates(runs["torch"], runs["jax"], tol) == [], runs


def test_the_script_merges_draws_and_refuses_another_configuration(tmp_path):
    """`scripts/scale_reference.py --merge-draws`: a float32 run of the same
    configuration joins `float32_draws`, a float64 one `float64_runs`, and a
    run of another configuration is refused."""
    import importlib.util
    import json
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts",
                        "scale_reference.py")
    spec = importlib.util.spec_from_file_location("scale_reference", path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    record = {k: v for k, v in scale_kitti00.load_record().items()
              if k not in ("float32_draws", "float64_runs")}
    rec_path = tmp_path / "record.json"
    rec_path.write_text(json.dumps(record))
    draw = dict(record, package="port", device="cuda", threads=None, jitter_ulps=1,
                ate_after_loop_m=record["ate_after_loop_m"] + 1e-3)
    f64 = dict(record, package="port", landmarks=60_000, gba_iters=0,
               float64_essential_graph=True, ate_m_after_steps={"30": 0.38})
    paths = []
    for i, d in enumerate((draw, f64)):
        paths.append(tmp_path / f"run{i}.json")
        paths[-1].write_text(json.dumps(d))
    out = script.main(["--merge-draws", str(rec_path)] + [str(p) for p in paths])
    assert [d["jitter_ulps"] for d in out["float32_draws"]] == [1]
    assert [r["landmarks"] for r in out["float64_runs"]] == [60_000]
    assert scale_kitti00.tolerances(out)["ate_after_loop_m"] == pytest.approx(1e-3)
    other = tmp_path / "other.json"
    other.write_text(json.dumps(dict(draw, landmarks=60_000)))
    with pytest.raises(ValueError, match="landmarks"):
        script.main(["--merge-draws", str(rec_path), str(other)])
