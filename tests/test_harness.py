"""CLI harness tests: odometry -> checkpoint -> slam, eval, and a 2-job sweep."""
import json
import os

import numpy as np
import pytest

from tbv_slam_public_tpu.harness import cli, sweep

FAST = ["radar.k_strongest=4", "features.cell_capacity=192",
        "features.grid_extent=60.0", "verification.peaks_capacity=1024",
        "loopclosure.local_map_capacity=1024", "scancontext.db_chunk=64",
        "odometry.compensate=false", "registration.cost=P2L",
        "verification.model_threshold=0.5"]


@pytest.fixture(scope="module")
def odometry_out(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("odom"))
    rc = cli.main(["odometry", "--dataset", "sim:80:5", "--output", out] + FAST)
    assert rc == 0
    return out


def test_odometry_outputs(odometry_out):
    out = odometry_out
    for f in ("odom/00.txt", "odom/00.tum", "odom/00_gt.txt",
              "odom/result.txt", "simple_graph.npz", "pars.txt",
              "time_statistics.txt"):
        assert os.path.exists(os.path.join(out, f)), f
    est = np.loadtxt(os.path.join(out, "odom", "00.txt"))
    assert est.shape[1] == 12 and est.shape[0] == 80
    # pars.txt echoes overrides
    pars = open(os.path.join(out, "pars.txt")).read()
    assert "radar.k_strongest, 4" in pars


def test_slam_from_checkpoint_cli(odometry_out, tmp_path):
    out = str(tmp_path / "slam")
    rc = cli.main(["slam", "--graph",
                   os.path.join(odometry_out, "simple_graph.npz"),
                   "--output", out] + FAST)
    assert rc == 0
    for f in ("est/00.txt", "est/result.txt", "odom/00.txt",
              "loop/loop.csv", "full_graph.npz", "time_statistics.txt",
              "plots/trajectory.png", "plots/constraint_map.png"):
        assert os.path.exists(os.path.join(out, f)), f


def test_slam_cli_without_matplotlib(odometry_out, tmp_path, capsys,
                                     monkeypatch):
    """matplotlib is optional: without it `slam` writes every result but
    the plots, says so on stderr, and succeeds."""
    import sys

    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import fails
    out = str(tmp_path / "slam")
    rc = cli.main(["slam", "--graph",
                   os.path.join(odometry_out, "simple_graph.npz"),
                   "--output", out] + FAST)
    assert rc == 0
    for f in ("est/00.txt", "loop/loop.csv", "full_graph.npz"):
        assert os.path.exists(os.path.join(out, f)), f
    assert not os.path.exists(os.path.join(out, "plots", "trajectory.png"))
    captured = capsys.readouterr()
    assert "no plots written" in captured.err
    assert "ate_rmse" in json.loads(captured.out.strip().splitlines()[-1])


def test_reoptimize_cli(odometry_out, tmp_path, capsys):
    """debug_optimizer analogue: re-run PGO on a saved full graph with
    overridden weights (tbv_slam_offline.cpp:289-330)."""
    out = str(tmp_path / "slam")
    rc = cli.main(["slam", "--graph",
                   os.path.join(odometry_out, "simple_graph.npz"),
                   "--output", out] + FAST)
    assert rc == 0
    capsys.readouterr()
    reopt = str(tmp_path / "full_graph2.npz")
    rc = cli.main(["reoptimize", "--graph",
                   os.path.join(out, "full_graph.npz"),
                   "--output", reopt, "pgo.loop_scaling=1e4"] + FAST)
    assert rc == 0
    m = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert m["cost"] <= m["cost0"]
    assert os.path.exists(reopt)


def test_constraints_cli(odometry_out, tmp_path, capsys):
    """DebugConstraints analogue (loopclosure.cpp:809-863): dump the loop
    constraints of a saved full graph with GT label geometry + measured
    covariances, and re-verify alignment quality from the stored payloads."""
    out = str(tmp_path / "slam")
    rc = cli.main(["slam", "--graph",
                   os.path.join(odometry_out, "simple_graph.npz"),
                   "--output", out] + FAST)
    assert rc == 0
    capsys.readouterr()
    csv_out = str(tmp_path / "constraints.csv")
    rc = cli.main(["constraints", "--graph",
                   os.path.join(out, "full_graph.npz"),
                   "--reverify", "--output", csv_out] + FAST)
    assert rc == 0
    m = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert m["n_loops"] >= 1
    assert m["reverified"] is True
    # measured covariances flow slam -> checkpoint -> dump (VERDICT r2 #4)
    assert m["n_with_cov"] >= 1
    assert os.path.exists(csv_out)
    header = open(csv_out).readline()
    for col in ("id_from", "id_to", "gt_err_m", "positive_ok",
                "alignment_quality", "cov_xx"):
        assert col in header, col


def test_eval_cli(odometry_out, tmp_path, capsys):
    gt = os.path.join(odometry_out, "odom", "00_gt.txt")
    est = os.path.join(odometry_out, "odom", "00.txt")
    rc = cli.main(["eval", "--gt", gt, "--est", est,
                   "--output", str(tmp_path / "result.txt")])
    assert rc == 0
    m = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "ate_rmse" in m and m["ate_rmse"] < 5.0


def test_sweep_two_jobs(tmp_path):
    par = tmp_path / "pars.csv"
    par.write_text("# sweep over the filter\nradar.k_strongest,4,6\n")
    out = str(tmp_path / "sweep")
    results = sweep.run_sweep(
        str(par), "sim:30:1", out,
        base_overrides=[t for t in FAST if not t.startswith("radar.")],
        workers=1, mode="odometry")
    assert len(results) == 2
    assert os.path.exists(os.path.join(out, "job_0", "odom", "00.txt"))
    assert os.path.exists(os.path.join(out, "job_1", "odom", "00.txt"))
    assert os.path.exists(os.path.join(out, "merged.csv"))
    assert results[0]["pars"] == "radar.k_strongest=4"
    assert results[1]["pars"] == "radar.k_strongest=6"


def test_train_alignment_cli(tmp_path, capsys):
    out = str(tmp_path / "train")
    rc = cli.main(["train-alignment", "--dataset", "sim:50:2",
                   "--output", out] + FAST)
    assert rc == 0
    assert os.path.exists(os.path.join(out, "trained_alignment_classifier.txt"))
    assert os.path.exists(os.path.join(out, "roc.csv"))
    m = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert m["samples"] >= 13
    assert m["accuracy"] > 0.6  # separates aligned from perturbed


def test_train_loop_cli(tmp_path, capsys):
    # synthetic tbv_model-style data: y depends on the features
    rng = np.random.default_rng(0)
    n = 500
    y = (rng.uniform(size=n) < 0.4).astype(float)
    odom = np.where(y > 0, 0.1, 0.7) + rng.normal(0, 0.05, n)
    sc = np.where(y > 0, 0.25, 0.6) + rng.normal(0, 0.05, n)
    align = np.where(y > 0, 2.0, -1.0) + rng.normal(0, 0.5, n)
    data = tmp_path / "train.txt"
    np.savetxt(data, np.stack([y, odom, sc, align], 1), delimiter=",")
    out = str(tmp_path / "trained_loop_classifier.txt")
    rc = cli.main(["train-loop", "--data", str(data), "--output", out])
    assert rc == 0
    assert os.path.exists(out)
    m = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert m["accuracy"] > 0.9


def test_baseline_aggregation(tmp_path):
    from tbv_slam_public_tpu.eval import kitti as kt
    # fabricate two job dirs with result.txt
    for j, ate in enumerate([4.0, 3.5]):
        d = tmp_path / f"job_{j}" / "est"
        d.mkdir(parents=True)
        m = kt.OdometryMetrics(
            trans_err_pct=1.1 + j * 0.1, rot_err_deg_per_100m=0.35, ate=ate,
            ate_rmse=ate, rpe_trans=0.07, rpe_trans_dev=0.05, rpe_rot=0.001,
            rpe_rot_dev=0.001, bias_x=0, bias_y=0, bias_theta=0,
            rmse_rpe=0.09, num_segments=100)
        kt.write_result(str(d / "result.txt"), j, m)
    from tbv_slam_public_tpu.eval import baseline
    report = baseline.write_baseline(str(tmp_path),
                                     str(tmp_path / "baseline.txt"))
    assert "job_0" in report and "job_1" in report
    assert "mean" in report and "3.750" in report  # mean ATE
    assert os.path.exists(tmp_path / "baseline.txt")


def test_evaluate_scans_cli(odometry_out, tmp_path, capsys):
    out = str(tmp_path / "scan_eval.csv")
    rc = cli.main(["evaluate-scans", "--graph",
                   os.path.join(odometry_out, "simple_graph.npz"),
                   "--output", out, "--max-pairs", "3"] + FAST)
    assert rc == 0
    m = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert m["pairs"] == 3
    rows = np.loadtxt(out, delimiter=",", skiprows=1)
    assert rows.shape[0] == m["samples"]
    assert rows.shape[1] == 11
    # the aligned sample (dx=dy=dtheta=0) must exist in each pair
    aligned = rows[rows[:, 4] > 0.5]
    assert len(aligned) == 3


def test_sweep_multihost_partition(tmp_path, monkeypatch):
    """The sweep's job list is round-robin partitioned across hosts
    (parallel.multihost.my_jobs — the multi-process eval.py analogue,
    VERDICT r3 #8): simulate host 1 of 2 and check only its share runs."""
    import tbv_slam_public_tpu.parallel.multihost as mh
    from tbv_slam_public_tpu.harness import sweep

    par = tmp_path / "pars.csv"
    par.write_text("radar.k_strongest,4,6\n"
                   "features.cell_capacity,128,192\n")  # 4 jobs
    monkeypatch.setattr(mh, "my_jobs",
                        lambda items: [x for i, x in enumerate(items)
                                       if i % 2 == 1])
    monkeypatch.setattr(mh, "scaling_report",
                        lambda frames, seconds: dict(
                            hosts=2, frames=int(frames), seconds=seconds,
                            frames_per_s=frames / max(seconds, 1e-9)))
    out = tmp_path / "sweep"
    results = sweep.run_sweep(
        str(par), "sim:12:3", str(out),
        base_overrides=["features.grid_extent=60.0",
                        "scancontext.db_chunk=64"],
        workers=1, max_frames=12, mode="odometry")
    assert [r["job"] for r in results] == [1, 3]
    assert (out / "job_1").exists() and (out / "job_3").exists()
    assert not (out / "job_0").exists()
    import json as _json
    rep = _json.loads((out / "sweep_report.json").read_text())
    assert rep["hosts"] == 2 and rep["total_jobs"] == 4
    assert rep["my_jobs"] == [1, 3]
    # merged.csv covers exactly this host's share
    merged = (out / "merged.csv").read_text().strip().splitlines()
    assert len(merged) == 3  # header + 2 rows


def test_odometry_cli_chunked_matches_per_frame(tmp_path):
    """`odometry --chunk N` (lax.scan device chunks) must write the same
    trajectory and checkpoint as the per-frame path."""
    import json as _json
    import subprocess
    import sys

    outs = {}
    for tag, extra_args in (("seq", []), ("chunk", ["--chunk", "7"])):
        out = tmp_path / tag
        cmd = [sys.executable, "-m", "tbv_slam_public_tpu.harness.cli",
               "odometry", "--dataset", "sim:25:4", "--output", str(out),
               *extra_args, "radar.k_strongest=4",
               "features.cell_capacity=192", "features.grid_extent=60.0",
               "registration.cost=P2L"]
        r = subprocess.run(cmd, capture_output=True, text=True, check=True)
        outs[tag] = (out, _json.loads(
            [l for l in r.stdout.splitlines() if l.startswith("{")][-1]))
    (seq_dir, seq_m), (chk_dir, chk_m) = outs["seq"], outs["chunk"]
    assert seq_m["keyframes"] == chk_m["keyframes"]
    a = np.loadtxt(seq_dir / "odom" / "00.txt")
    b = np.loadtxt(chk_dir / "odom" / "00.txt")
    np.testing.assert_allclose(a, b, atol=1e-5)
