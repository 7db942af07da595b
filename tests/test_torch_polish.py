"""Pose-graph polish (``global_init.polish``) against the JAX package.

``polish_poses`` on a drifted and a hinged copy of the true poses of the
arc scene of ``tests/test_torch_global.py``, the engine's two adoption
gates on those and on a hostile graph, the rollback, and the port's engine
rebuilding a drifted model on its CPU twins. Both packages average over
JAX's relative poses, so that a difference shows in the averaging and the
gates. Tolerances are stated per test.
"""
import numpy as np
import pytest
from scipy.spatial.transform import Rotation

from sfm_tpu.reconstruction import StructureFromMotion as JSfM
from sfm_tpu.reconstruction import global_init as jgi
from sfm_tpu_torch.reconstruction import global_init as tgi
from sfm_tpu_torch.reconstruction import incremental as tinc

from test_polish import drifted_poses
from test_torch_global import (N_CAMS, gauge_free_deg, jax_config, jrel, port_config,  # noqa: F401
                               port_table, scene_table)


def hinged_poses(scene, deg=40.0):
    n_img = scene["R"].shape[0]
    D = Rotation.from_euler("y", np.radians(deg)).as_matrix()
    rvec = np.zeros((n_img, 3), np.float32)
    tvec = np.zeros((n_img, 3), np.float32)
    for c in range(n_img):
        C = -scene["R"][c].T @ scene["t"][c]
        R, Cc = scene["R"][c], C
        if c >= n_img // 2:
            R, Cc = scene["R"][c] @ D.T, D @ C
        rvec[c] = Rotation.from_matrix(R).as_rotvec()
        tvec[c] = -R @ Cc
    return rvec, tvec


@pytest.fixture(scope="module")
def polished(scene_table, jrel):
    """polish_poses of both packages from JAX's relative poses, per bend:
    {bend: (inputs, JAX's result, the port's result)}."""
    scene, table = scene_table
    saved = jgi.pairwise_relative_poses, tgi.pairwise_relative_poses
    jgi.pairwise_relative_poses = tgi.pairwise_relative_poses = lambda *a, **k: dict(jrel)
    try:
        out = {}
        reg = np.ones(N_CAMS, bool)
        for bend in ("drift", "hinge"):
            rvec, tvec = drifted_poses(scene) if bend == "drift" else hinged_poses(scene)
            out[bend] = ((rvec, tvec),
                         jgi.polish_poses(table, scene["K"], N_CAMS, rvec, tvec, reg),
                         tgi.polish_poses(port_table(table), scene["K"], N_CAMS, rvec, tvec,
                                          reg, device="cpu"))
        return out
    finally:
        jgi.pairwise_relative_poses, tgi.pairwise_relative_poses = saved


@pytest.mark.parametrize("bend", ["drift", "hinge"])
def test_polish_poses_match_jax(scene_table, polished, bend):
    # Both sides from JAX's relative poses. The same placed cameras;
    # rotations within 0.05 deg of each other after removing the gauge; both
    # within 2 deg of the truth; the output scale re-aligned to the input
    # model's (median baseline within 1e-3 of JAX's). The seed choice is the
    # same unless the two seeds' scores tie within the f32 arccos of the
    # residuals (~0.03 deg): on the hinge both seeds reach the same poses
    # and the choice between them is that noise.
    scene, _ = scene_table
    _, (rv_j, tv_j, placed_j, rel_j), (rv_t, tv_t, placed_t, rel_t) = polished[bend]
    if rel_t["seed_choice"] != rel_j["seed_choice"]:
        (o_inc, med_inc), (o_tree, med_tree) = (rel_t["seed_scores"][k]
                                                for k in ("incremental", "tree"))
        assert o_inc == o_tree and abs(med_inc - med_tree) < 0.05
    np.testing.assert_array_equal(placed_t, placed_j)
    Rj = Rotation.from_rotvec(rv_j).as_matrix()
    Rt = Rotation.from_rotvec(rv_t).as_matrix()
    assert gauge_free_deg(Rt, Rj) < 0.05
    assert gauge_free_deg(Rt, scene["R"]) < 2.0
    i, j = rel_j["pairs"][:, 0], rel_j["pairs"][:, 1]
    Cj = -np.einsum("nba,nb->na", Rj, tv_j)
    Ct = -np.einsum("nba,nb->na", Rt, tv_t)
    base = lambda C: np.median(np.linalg.norm(C[j] - C[i], axis=-1))
    assert base(Ct) == pytest.approx(base(Cj), rel=1e-3)


def engines(scene, table, **gi_kw):
    sections = dict(pnp=dict(ransac_iters=512),
                    ba=dict(max_iterations=15, cg_iters=40, optimize_intrinsics=False),
                    global_init=dict(polish=True, **gi_kw))
    return (JSfM(table, scene["xy"], jax_config(**sections)),
            tinc.StructureFromMotion(port_table(table), scene["xy"], port_config(**sections),
                                     device="cpu"))


def set_model(sfm, rvec, tvec):
    sfm.rvec[:] = rvec
    sfm.tvec[:] = tvec
    sfm.registered[:] = True
    sfm.reg_order = list(range(len(rvec)))


@pytest.mark.parametrize("case", ["drift", "hinge", "hostile"])
def test_polish_adoption_matches_jax(scene_table, polished, monkeypatch, case):
    # The same adoption decision and gate readings (residuals within 0.05
    # deg), each package's engine on its own polish_poses result (the module
    # fixture's). The rebuild stages are stubbed on both sides (the engine
    # test below runs them), so the incremental model has no points to lose.
    scene, table = scene_table
    decisions = []
    for k, (pkg, sfm) in enumerate(zip((jgi, tgi), engines(scene, table))):
        if case == "hostile":
            def fake_polish(table_, K, num_images, rvec, tvec, registered, **kw):
                # Measured pair rotations consistent with the truth, estimate garbage.
                bad = np.random.default_rng(0).normal(size=(num_images, 3)).astype(np.float32)
                p = np.asarray(table_.pairs[table_.accept], np.int32)
                Rg = scene["R"]
                rel = {"pairs": p, "R": np.einsum("pab,pcb->pac", Rg[p[:, 1]], Rg[p[:, 0]])}
                return bad, np.zeros((num_images, 3), np.float32), registered.copy(), rel
            rvec = Rotation.from_matrix(scene["R"]).as_rotvec().astype(np.float32)
            tvec = scene["t"].astype(np.float32)
        else:
            (rvec, tvec), *results = polished[case]
            fake_polish = lambda *a, res=results[k], **kw: (res[0].copy(), res[1].copy(),
                                                             res[2].copy(), dict(res[3]))
        monkeypatch.setattr(pkg, "polish_poses", fake_polish)
        set_model(sfm, rvec, tvec)
        monkeypatch.setattr(sfm, "_triangulate", lambda **kw: 0)
        monkeypatch.setattr(sfm, "bundle_adjust", lambda final=False: None)
        monkeypatch.setattr(sfm, "prune_observations", lambda *a: None)
        decisions.append((sfm.pose_graph_polish(), dict(sfm._polish_stats), sfm.rvec.copy()))
    (adopt_j, st_j, rv_j), (adopt_t, st_t, rv_t) = decisions
    assert adopt_t == adopt_j == (case != "hostile")
    assert st_t["polish_applied"] == st_j["polish_applied"]
    for k in ("polish_pair_residual_deg_before", "polish_pair_residual_deg_after"):
        assert st_t[k] == pytest.approx(st_j[k], abs=0.05)
    assert st_t["polish_pair_outlier_frac"] == st_j["polish_pair_outlier_frac"]
    if case == "hostile":
        np.testing.assert_array_equal(rv_t, rv_j)    # the incremental poses kept


def test_polish_rollback_matches_jax(scene_table, monkeypatch):
    # A rebuild that keeps 10 of 200 points rolls back on both sides; the
    # saved state comes back byte for byte.
    scene, table = scene_table
    for pkg, sfm in zip((jgi, tgi), engines(scene, table)):
        set_model(sfm, np.zeros((N_CAMS, 3), np.float32), np.zeros((N_CAMS, 3), np.float32))
        sfm.point_valid[:200] = True
        sfm.points[:200] = 1.0
        rvec0, pv0 = sfm.rvec.copy(), sfm.point_valid.copy()

        def fake_polish(table_, K, num_images, rvec, tvec, registered, **kw):
            p = np.asarray(table_.pairs[table_.accept], np.int32)
            rel = {"pairs": p, "R": np.zeros((len(p), 3, 3), np.float32)}
            return rvec + 0.01, tvec.copy(), registered.copy(), rel

        def bad_triangulate(sfm=sfm, **kw):
            sfm.point_valid[:] = False
            sfm.point_valid[:10] = True
            return 10

        monkeypatch.setattr(pkg, "polish_poses", fake_polish)
        monkeypatch.setattr(pkg, "pair_rotation_residuals",
                            lambda rv, pairs, R: np.full(len(pairs), 0.05, np.float32))
        monkeypatch.setattr(sfm, "_triangulate", bad_triangulate)
        monkeypatch.setattr(sfm, "bundle_adjust", lambda final=False: None)
        monkeypatch.setattr(sfm, "prune_observations", lambda *a: None)
        assert not sfm.pose_graph_polish()
        assert sfm._polish_stats["polish_rolled_back"]
        assert sfm._polish_stats["polish_points_after_rebuild"] == 10
        np.testing.assert_array_equal(sfm.rvec, rvec0)
        np.testing.assert_array_equal(sfm.point_valid, pv0)
        assert sfm.registered.all()


def test_engine_polish_rebuilds_drifted_model(scene_table, jrel, monkeypatch):
    # The port's engine end to end on the CPU twins: polish adopted, the
    # cloud rebuilt in the polished frame, poses within 2 deg of the truth.
    scene, table = scene_table
    monkeypatch.setattr(tgi, "pairwise_relative_poses", lambda *a, **k: dict(jrel))
    _, sfm = engines(scene, table, refine_rounds=1)
    set_model(sfm, *drifted_poses(scene))
    assert sfm.pose_graph_polish()
    st = sfm._polish_stats
    assert st["polish_applied"] and st["polish_seed_choice"] in ("incremental", "tree")
    assert st["polish_pair_residual_deg_after"] < st["polish_pair_residual_deg_before"]
    assert gauge_free_deg(Rotation.from_rotvec(sfm.rvec).as_matrix(), scene["R"]) < 2.0
    assert sfm.point_valid.sum() > 100
    assert sfm.compute_stats()["mean_reprojection_error"] < 1.0


