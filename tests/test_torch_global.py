"""Global SfM and pose-graph polish (kernel K13's twins), and K1's epilogue,
against the JAX package.

The relative poses, rotation and translation averaging, their host pieces
(forest, tree inits, cycle weights), ``global_poses`` and the engine's
global path and routing run through both packages on the same numpy-seeded
inputs: the synthetic arc scene of ``tests/test_reconstruction.py`` and the
ring and chain graphs of ``tests/test_global_init.py``
(``tests/test_torch_polish.py`` holds the polish on the same scene).
Tolerances are stated per test; averaged poses are compared after removing
the gauge (relative rotations, similarity-aligned centers), never as raw
arrays.
"""
import dataclasses

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from torch_parity import n, t

from sfm_tpu.config import (BAConfig, GlobalInitConfig, MatchConfig, PnPConfig, SfMConfig,
                            VerifyConfig)
from sfm_tpu.io.calib import umeyama
from sfm_tpu.matching import all_pairs_sweep
from sfm_tpu.matching.core import _match_descriptors as j_match
from sfm_tpu.reconstruction import StructureFromMotion as JSfM
from sfm_tpu.reconstruction import global_init as jgi
from sfm_tpu_torch import cli
from sfm_tpu_torch import config as tc
from sfm_tpu_torch.matching.core import match_descriptors as t_match
from sfm_tpu_torch.matching.pair_table import PairTable as TPairTable
from sfm_tpu_torch.reconstruction import global_init as tgi
from sfm_tpu_torch.reconstruction import incremental as tinc

from test_reconstruction import make_multiview

N_CAMS = 8
GLOBAL_SECTIONS = dict(pnp=dict(ransac_iters=512),
                       ba=dict(max_iterations=15, cg_iters=40, optimize_intrinsics=False),
                       global_init=dict(enabled=True))


def rot_angle_deg(A, B):
    """Geodesic angle (deg) of A B^T, from both its trace and its skew part:
    arccos of the trace alone cannot resolve less than ~0.03 deg between f32
    rotations, whose rows are orthonormal to ~1e-7."""
    A, B = np.asarray(A, np.float64), np.asarray(B, np.float64)
    dR = A @ np.swapaxes(B, -1, -2)
    cos = (np.trace(dR, axis1=-2, axis2=-1) - 1) / 2
    v = np.stack([dR[..., 2, 1] - dR[..., 1, 2], dR[..., 0, 2] - dR[..., 2, 0],
                  dR[..., 1, 0] - dR[..., 0, 1]], -1)
    return np.degrees(np.arctan2(0.5 * np.linalg.norm(v, axis=-1), cos))


def gauge_free_deg(RA, RB):
    """Max over cameras of the angle between R_i R_0^T of both sets."""
    return max(float(rot_angle_deg(RA[i] @ RA[0].T, RB[i] @ RB[0].T)) for i in range(len(RA)))


def aligned_center_err(CA, CB):
    """Max center error of CA similarity-aligned to CB, over CB's extent."""
    s, Q, T = umeyama(np.asarray(CA, np.float64), np.asarray(CB, np.float64))
    err = np.linalg.norm(s * CA @ Q.T + T - CB, axis=1)
    return float(err.max() / np.linalg.norm(CB - CB.mean(0), axis=1).mean())


def ring_pairs(rng, n_cams, extra):
    pairs = [(i, (i + 1) % n_cams) for i in range(n_cams)]
    while len(pairs) < n_cams + extra:
        i, j = rng.integers(0, n_cams, 2)
        if i != j and (min(i, j), max(i, j)) not in pairs:
            pairs.append((min(i, j), max(i, j)))
    return np.array([(min(i, j), max(i, j)) for i, j in pairs], np.int32)


def port_table(table):
    return TPairTable(**{f.name: np.array(getattr(table, f.name))
                         for f in dataclasses.fields(TPairTable)})


def port_config(**sections):
    """The port's SfMConfig with the same section overrides as the JAX one."""
    kinds = {"pnp": tc.PnPConfig, "ba": tc.BAConfig, "global_init": tc.GlobalInitConfig}
    return tc.SfMConfig(**{k: kinds[k](**v) for k, v in sections.items()})


def jax_config(**sections):
    kinds = {"pnp": PnPConfig, "ba": BAConfig, "global_init": GlobalInitConfig}
    return SfMConfig(**{k: kinds[k](**v) for k, v in sections.items()})


@pytest.fixture(scope="module")
def scene_table():
    scene = make_multiview(np.random.default_rng(23))
    cfg = SfMConfig(matching=MatchConfig(max_matches=256), verify=VerifyConfig(ransac_iters=512))
    table = all_pairs_sweep(scene["xy"], scene["desc"], scene["valid"], cfg, chunk_size=8)
    return scene, table


@pytest.fixture(scope="module")
def jrel(scene_table):
    scene, table = scene_table
    return jgi.pairwise_relative_poses(table, scene["K"])


# ------------------------------------------------------------ K13-a: relative poses

def test_relative_poses_match_jax(scene_table, jrel):
    # Tolerance: rotations within 0.01 deg and unit t within 1e-4 (f32 on the
    # CPU, another summation order); the cheirality counts equal.
    scene, table = scene_table
    got = tgi.pairwise_relative_poses(port_table(table), scene["K"], device="cpu")
    np.testing.assert_array_equal(got["pairs"], jrel["pairs"])
    np.testing.assert_array_equal(got["weight"], jrel["weight"])
    assert rot_angle_deg(got["R"], jrel["R"]).max() < 0.01
    assert np.abs(got["R"] - jrel["R"]).max() < 1e-4
    np.testing.assert_allclose(got["t"], jrel["t"], atol=1e-4)
    np.testing.assert_array_equal(got["cheirality_good"], jrel["cheirality_good"])
    assert len(got["pairs"]) == N_CAMS * (N_CAMS - 1) // 2


# ------------------------------------------------------------ rotation algebra

def test_nearest_rotation_matches_jax(rng):
    # Tolerance: 1e-5 absolute (24 f32 power steps on both sides); det < 0
    # inputs land in SO(3).
    A = rng.normal(size=(16, 3, 3)).astype(np.float32)
    R_gt = Rotation.random(8, random_state=rng).as_matrix().astype(np.float32)
    flipped = R_gt.copy()
    flipped[:, :, 2] *= -1
    A = np.concatenate([A, R_gt + 0.01, flipped])
    got = n(tgi.nearest_rotation(t(A)))
    np.testing.assert_allclose(got, np.asarray(jgi.nearest_rotation(A)), atol=1e-5)
    assert np.all(np.linalg.det(got) > 0.999)


def test_log_so3_matches_jax(rng):
    # Tolerance: 1e-5 absolute, over generic, tiny and near-pi angles.
    rv = np.concatenate([rng.normal(size=(8, 3)), 1e-6 * rng.normal(size=(4, 3)),
                         3.1 * np.eye(3)]).astype(np.float32)
    R = Rotation.from_rotvec(rv).as_matrix().astype(np.float32)
    np.testing.assert_allclose(n(tgi._log_so3(t(R))), np.asarray(jgi._log_so3(R)), atol=1e-5)


# ------------------------------------------------------------ K13-b / K13-c: averaging

def chain_graph(rng, n_cams=60, window=4):
    yaw = np.cumsum(rng.normal(scale=0.02, size=n_cams))
    R_gt = Rotation.from_euler("y", yaw[:, None]).as_matrix().astype(np.float32)
    pairs = np.array([(i, j) for i in range(n_cams)
                      for j in range(i + 1, min(i + 1 + window, n_cams))], np.int32)
    return R_gt, pairs


@pytest.mark.parametrize("case", ["exact", "noisy_outliers", "chain_tree_init"])
def test_rotation_averaging_matches_jax(rng, case):
    # Tolerance: after removing the gauge, port and JAX within 0.05 deg of
    # each other (f32 CG over another summation order), and both within the
    # reference's own accuracy of the truth.
    if case == "chain_tree_init":
        R_gt, pairs = chain_graph(rng)
    else:
        n_cams = 12 if case == "exact" else 14
        R_gt = Rotation.random(n_cams, random_state=rng).as_matrix().astype(np.float32)
        pairs = ring_pairs(rng, n_cams, 12 if case == "exact" else 24)
    noise = (np.tile(np.eye(3), (len(pairs), 1, 1)) if case == "exact" else Rotation.from_rotvec(
        rng.normal(scale=np.deg2rad(0.3 if case == "chain_tree_init" else 2.0),
                   size=(len(pairs), 3))).as_matrix())
    R_rel = np.einsum("pab,pbc,pdc->pad", noise, R_gt[pairs[:, 1]],
                      R_gt[pairs[:, 0]]).astype(np.float32)
    if case == "noisy_outliers":
        R_rel[3] = Rotation.random(random_state=rng).as_matrix()
        R_rel[7] = Rotation.random(random_state=rng).as_matrix()
    w = rng.uniform(20, 200, len(pairs)).astype(np.float32)
    N = len(R_gt)
    init = None
    if case == "chain_tree_init":
        init = tgi.tree_init_rotations(tgi.spanning_forest(pairs, w, N), R_rel, N)
    ref = jgi.rotation_averaging(pairs, R_rel, w, N, init=init)
    got = tgi.rotation_averaging(pairs, R_rel, w, N, init=init, device="cpu")
    assert gauge_free_deg(got, ref) < 0.05
    assert gauge_free_deg(got, R_gt) < {"exact": 0.5, "noisy_outliers": 6.0,
                                        "chain_tree_init": 3.0}[case]


@pytest.mark.parametrize("with_init", [False, True])
def test_translation_averaging_matches_jax(rng, with_init):
    # Tolerance: centers similarity-aligned to JAX's within 1e-3 of the
    # scene's extent (f32 CG, 80 steps, another summation order).
    n_cams = 10
    R_gt = Rotation.random(n_cams, random_state=rng).as_matrix().astype(np.float32)
    C_gt = (rng.normal(size=(n_cams, 3)) * 3.0).astype(np.float32)
    pairs = ring_pairs(rng, n_cams, 16)
    t_rel = np.stack([R_gt[j] @ (C_gt[i] - C_gt[j]) for i, j in pairs])
    t_rel = (t_rel / np.linalg.norm(t_rel, axis=-1, keepdims=True)
             + rng.normal(scale=0.01, size=t_rel.shape)).astype(np.float32)
    w = rng.uniform(20, 200, len(pairs)).astype(np.float32)
    init = None
    if with_init:
        init = tgi.tree_init_centers(tgi.spanning_forest(pairs, w, n_cams), R_gt, pairs, t_rel,
                                     n_cams)
    ref = jgi.translation_averaging(pairs, R_gt, t_rel, w, n_cams, init=init)
    got = tgi.translation_averaging(pairs, R_gt, t_rel, w, n_cams, init=init, device="cpu")
    assert aligned_center_err(got, ref) < 1e-3
    assert aligned_center_err(got, C_gt) < 0.05
    base = np.linalg.norm(got[pairs[:, 1]] - got[pairs[:, 0]], axis=-1)
    assert np.median(base) == pytest.approx(1.0, abs=1e-5)      # the host's scale gauge


def test_kernel_twins_through_the_dispatchers(rng):
    # The wrappers run their twins on CPU tensors and refuse other devices.
    R_gt, pairs = chain_graph(rng, 10, 3)
    w = torch.ones(len(pairs))
    X = t(np.tile(np.eye(3, dtype=np.float32), (10, 1)))
    R_rel = t(np.einsum("pab,pcb->pac", R_gt[pairs[:, 1]], R_gt[pairs[:, 0]]))
    got = tgi.rotation_average(t(pairs), R_rel, w, X, 4, 2)
    assert torch.equal(got, tgi.rotation_average_plain(t(pairs), R_rel, w, X, 4, 2))
    m = lambda *s, **k: torch.empty(s, device="meta", **k)
    with pytest.raises(ValueError, match="device"):
        tgi.relpose(m(2, 8, 2), m(2, 8, 2), m(2, 8))
    with pytest.raises(ValueError, match="device"):
        tgi.rotation_average(m(3, 2, dtype=torch.int32), m(3, 3, 3), m(3), m(9, 3))
    with pytest.raises(ValueError, match="device"):
        tgi.translation_average(m(3, 2, dtype=torch.int32), m(3, 3), m(3), m(3, 3))


# ------------------------------------------------------------ host pieces

def test_forest_and_cycle_weights_equal_jax(scene_table, jrel, rng):
    # Host numpy on both sides: equal arrays.
    w = jrel["weight"] * rng.uniform(0.5, 1.0, len(jrel["weight"])).astype(np.float32)
    for a, b in zip(tgi.spanning_forest(jrel["pairs"], w, N_CAMS),
                    jgi.spanning_forest(jrel["pairs"], w, N_CAMS)):
        np.testing.assert_array_equal(a, b)
    R_bad = jrel["R"].copy()
    R_bad[2] = Rotation.from_rotvec([0.0, 0.6, 0.0]).as_matrix() @ R_bad[2]
    np.testing.assert_array_equal(tgi.cycle_consistency_weights(jrel["pairs"], R_bad),
                                  jgi.cycle_consistency_weights(jrel["pairs"], R_bad))
    forest = jgi.spanning_forest(jrel["pairs"], w, N_CAMS)
    np.testing.assert_array_equal(tgi.tree_init_rotations(forest, jrel["R"], N_CAMS),
                                  jgi.tree_init_rotations(forest, jrel["R"], N_CAMS))


@pytest.fixture(scope="module")
def jglobal(scene_table, jrel):
    """JAX's global path from its own relative poses: (the global_poses
    output its engine saw, the engine's result)."""
    scene, table = scene_table
    seen = {}
    saved_rel, saved_poses = jgi.pairwise_relative_poses, jgi.global_poses

    def spy(*a, **k):
        seen["poses"] = saved_poses(*a, **k)
        return seen["poses"]

    jgi.pairwise_relative_poses = lambda *a, **k: dict(jrel)
    jgi.global_poses = spy
    try:
        res = JSfM(table, scene["xy"], jax_config(**GLOBAL_SECTIONS)).run_global_reconstruction()
    finally:
        jgi.pairwise_relative_poses, jgi.global_poses = saved_rel, saved_poses
    return seen["poses"], res


def test_global_poses_match_jax(scene_table, jrel, jglobal, monkeypatch):
    # Both sides averaged over JAX's relative poses. Tolerance: rotations
    # within 0.05 deg and centers within 1e-3 of the extent of each other,
    # after removing the gauge; both within 3 deg of the truth.
    scene, table = scene_table
    monkeypatch.setattr(tgi, "pairwise_relative_poses", lambda *a, **k: dict(jrel))
    rv_j, tv_j, placed_j, _ = jglobal[0]
    rv_t, tv_t, placed_t = tgi.global_poses(port_table(table), scene["K"], N_CAMS,
                                            tc.GlobalInitConfig(), device="cpu")
    np.testing.assert_array_equal(placed_t, placed_j)
    Rj = Rotation.from_rotvec(rv_j).as_matrix()
    Rt = Rotation.from_rotvec(rv_t).as_matrix()
    assert gauge_free_deg(Rt, Rj) < 0.05
    assert gauge_free_deg(Rt, scene["R"]) < 3.0
    Cj = -np.einsum("nba,nb->na", Rj, tv_j)
    Ct = -np.einsum("nba,nb->na", Rt, tv_t)
    assert aligned_center_err(Ct, Cj) < 1e-3


def test_pair_rotation_residuals_match_jax(jrel, rng):
    rv = rng.normal(scale=0.3, size=(N_CAMS, 3)).astype(np.float32)
    np.testing.assert_allclose(tgi.pair_rotation_residuals(rv, jrel["pairs"], jrel["R"]),
                               jgi.pair_rotation_residuals(rv, jrel["pairs"], jrel["R"]),
                               atol=1e-3)


# ------------------------------------------------------------ the engine's global path

def test_run_global_reconstruction_matches_jax(scene_table, jrel, jglobal, monkeypatch):
    # Both engines from JAX's relative poses. The same cameras; final poses
    # within 0.5 deg of each other (gauge removed: BA and the triangulation
    # gates sum in another order) and within 2 deg of the truth; points
    # within 5%; the self-diagnostic below its gates.
    scene, table = scene_table
    monkeypatch.setattr(tgi, "pairwise_relative_poses", lambda *a, **k: dict(jrel))
    ref = jglobal[1]
    sfm = tinc.StructureFromMotion(port_table(table), scene["xy"],
                                   port_config(**GLOBAL_SECTIONS), device="cpu")
    got = sfm.run_global_reconstruction()
    np.testing.assert_array_equal(np.sort(got.image_ids), np.sort(ref.image_ids))
    assert len(got.image_ids) == N_CAMS
    R_got = got.rotations[np.argsort(got.image_ids)]
    R_ref = ref.rotations[np.argsort(ref.image_ids)]
    assert gauge_free_deg(R_got, R_ref) < 0.5
    assert gauge_free_deg(R_got, scene["R"][np.sort(got.image_ids)]) < 2.0
    st = got.stats
    assert st["mean_reprojection_error"] < 1.0 and st["num_points"] > 100
    assert st["global_pair_residual_deg"] < 2.0 and st["global_pair_outlier_frac"] < 0.05
    assert abs(st["num_points"] - ref.stats["num_points"]) <= 0.05 * ref.stats["num_points"]


def tiny_table(pairs, K=4):
    P = len(pairs)
    return TPairTable(
        pairs=np.asarray(pairs, np.int32), accept=np.ones(P, bool),
        num_matches=np.full(P, K, np.int32), num_inliers=np.full(P, K, np.int32),
        inlier_ratio=np.ones(P, np.float32), reprojection_error=np.zeros(P, np.float32),
        well_distributed=np.ones(P, bool), F=np.tile(np.eye(3, dtype=np.float32), (P, 1, 1)),
        xy1=np.zeros((P, K, 2), np.float32), xy2=np.zeros((P, K, 2), np.float32),
        idx1=np.tile(np.arange(K, dtype=np.int32), (P, 1)),
        idx2=np.tile(np.arange(K, dtype=np.int32), (P, 1)),
        match_valid=np.ones((P, K), bool), inliers=np.ones((P, K), bool))


@pytest.mark.parametrize("case", ["routes_global", "sparse_precheck", "inconsistent_fallback"])
def test_global_routing(rng, monkeypatch, case):
    # The reference's router: global when enabled; the incremental engine on
    # a pair graph with fewer than min_edges_per_camera edges a camera; a
    # global model above fallback_outlier_frac discarded and the state reset.
    pairs = [[0, 1], [1, 2], [2, 3]] if case == "sparse_precheck" else [[0, 1], [0, 2], [1, 2]]
    n_img = 5 if case == "sparse_precheck" else 3
    xy = rng.uniform(0, 100, (n_img, 4, 2)).astype(np.float32)
    sfm = tinc.StructureFromMotion(tiny_table(pairs), xy,
                                   port_config(global_init=dict(enabled=True)), device="cpu")
    seen = {}

    class _Res:
        stats = {"global_pair_outlier_frac": 0.9 if case == "inconsistent_fallback" else 0.0}

    def fake_global(self):
        seen["global"] = True
        self.registered[:] = True
        self.reg_order = list(range(n_img))
        return _Res()

    def fake_incremental(self):
        seen["incremental_from"] = (len(self.reg_order), int(self.registered.sum()))
        raise RuntimeError("incremental path reached")

    monkeypatch.setattr(tinc.StructureFromMotion, "run_global_reconstruction", fake_global)
    monkeypatch.setattr(tinc.StructureFromMotion, "initialize", fake_incremental)
    if case == "routes_global":
        assert isinstance(sfm.run_reconstruction(), _Res)
        assert "incremental_from" not in seen
        return
    with pytest.raises(RuntimeError, match="incremental path"):
        sfm.run_reconstruction()
    assert seen.get("global", False) == (case == "inconsistent_fallback")
    assert seen["incremental_from"] == (0, 0)      # a fresh state


def test_cli_flags_map_to_config(tmp_path, monkeypatch):
    seen = []

    class FakePipeline:
        def __init__(self, pargs, cfg):
            seen.append(cfg.global_init)

        def run_reconstruction(self):
            return True

    monkeypatch.setattr(cli, "SfMPipeline", FakePipeline)
    for flags, expect in (([], (False, False)), (["--global_init"], (True, False)),
                          (["--polish"], (False, True))):
        assert cli.main(["--log_dir", str(tmp_path / "logs"), "reconstruct", "--data_dir",
                         str(tmp_path), "--device", "cpu", *flags]) == 0
        assert (seen[-1].enabled, seen[-1].polish) == expect


# ------------------------------------------------------------ K1's epilogue on ties

@pytest.mark.parametrize("mutual", [True, False])
def test_match_descriptors_tie_heavy_equals_jax(mutual):
    # +-1/16 descriptors (D = 256): every dot product is a multiple of 1/256,
    # exact in f32, so distances tie exactly; duplicated rows and columns
    # make ties in the row top-2, the column argmin and the compaction.
    # Invalid rows and columns. Indices equal, index for index.
    rng = np.random.default_rng(4)
    K1, K2, D = 160, 176, 256
    base = np.where(rng.random((96, D)) < 0.5, -1.0, 1.0) / 16.0
    d1 = base[rng.integers(0, 96, K1)].copy()
    d2 = base[rng.integers(0, 96, K2)].copy()
    flip = rng.random(d2.shape) < 0.04
    d2[flip] *= -1
    d2[::7] = d2[3]
    d1[::11] = d1[5]
    v1 = rng.random(K1) > 0.1
    v2 = rng.random(K2) > 0.1
    v2[3] = True
    d1, d2 = d1.astype(np.float32), d2.astype(np.float32)
    for ratio in (0.75, 0.99):
        ref = j_match(d1, v1, d2, v2, ratio_threshold=ratio, max_matches=128,
                      mutual_check=mutual)
        got = t_match(t(d1)[None], t(v1)[None], t(d2)[None], t(v2)[None],
                      ratio_threshold=ratio, max_matches=128, mutual_check=mutual)
        for k in ("idx1", "idx2", "valid"):
            np.testing.assert_array_equal(n(got[k][0]), np.asarray(ref[k]), err_msg=k)
        np.testing.assert_array_equal(n(got["distance"][0]), np.asarray(ref["distance"]))
        assert np.asarray(ref["valid"]).sum() > 20
