"""The plain twins of kernels K2, K4, K6 and K10's newest entries against JAX.

Each CUDA kernel of these entries is held against its twin on the card by
``chip_smoke.py``; here the twins (what a wrapper runs on a CPU tensor) are
held against the JAX package on inputs made from a numpy seed and handed to
both. Tolerances are stated per test; all are float32 on both sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import n, t
from test_torch_ba import jax_linearization, perturbed_problem
from test_torch_matching import two_view

from sfm_tpu.ba.schur import back_substitute as j_back
from sfm_tpu.ba.schur import damp_operator as j_damp
from sfm_tpu.estimators.pnp import refine_pose_gn as j_refine
from sfm_tpu.estimators.ransac import ransac_select as j_select
from sfm_tpu.features import detect as jdet
from sfm_tpu.geometry.epipolar import eight_point as j_eight_point
from sfm_tpu.geometry.epipolar import symmetric_epipolar_distance as j_sym
from sfm_tpu.geometry.projection import project as j_project
from sfm_tpu.matching.verify import _masked_std as j_masked_std
from sfm_tpu_torch.ba import schur as tschur
from sfm_tpu_torch.estimators import fundamental as tfm
from sfm_tpu_torch.estimators import pnp as tpnp
from sfm_tpu_torch.estimators import ransac as tran
from sfm_tpu_torch.features import detect as tdet
from sfm_tpu_torch.geometry.epipolar import normalize_points
from sfm_tpu_torch.geometry.rotations import rodrigues
from sfm_tpu_torch.utils.linalg import _adjugate3

K_NP = np.array([[1228.0, 0, 512.0], [0, 1228.0, 384.0], [0, 0, 1]], np.float32)


def rot_angle(Ra, Rb):
    """Angle (rad) between rotation matrices, from the skew part in f64."""
    M = np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64)
    v = np.array([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0], M[1, 0] - M[0, 1]])
    return float(np.arcsin(min(np.linalg.norm(v) / 2, 1.0)))


# ------------------------------------------------------------------ K6


def pnp_scene(rng, B=3, N=400):
    R = n(rodrigues(t(rng.normal(0, 0.3, (B, 3)))))
    tv = rng.uniform([-1, -1, 4], [1, 1, 6], (B, 3)).astype(np.float32)
    p3 = rng.uniform(-2, 2, (B, N, 3)).astype(np.float32)
    cam = np.einsum("bij,bnj->bni", R, p3) + tv[:, None]
    p2 = (cam[..., :2] / cam[..., 2:]) * K_NP[0, 0] + K_NP[:2, 2]
    p2 = (p2 + rng.normal(0, 0.5, p2.shape)).astype(np.float32)
    out = rng.random((B, N)) < 0.3
    p2[out] = rng.uniform([0, 0], [1024, 768], (out.sum(), 2))
    valid = np.arange(N)[None] < rng.integers(N // 2, N + 1, (B, 1))
    R0 = n(rodrigues(t(rng.normal(0, 0.006, (B, 3))))) @ R
    t0 = (tv * (1 + rng.normal(0, 0.01, (B, 3)))).astype(np.float32)
    return R0.astype(np.float32), t0, p3, p2, valid


def jax_pnp_refit(R0, t0, p3, p2, valid, ok0, thr=8.0, iters=10):
    """sfm_tpu/estimators/pnp.py:329-349 from the winner on, one candidate."""
    K = jnp.asarray(K_NP)
    proj, depth = j_project(p3, R0, t0, K)
    err = jnp.linalg.norm(proj - p2, axis=-1)
    w = ((err < thr) & (depth > 0) & valid & ok0).astype(jnp.float32)
    R, tv = j_refine(R0, t0, p3, p2, K, w, iters=iters)
    proj, depth = j_project(p3, R, tv, K)
    w2 = ((jnp.linalg.norm(proj - p2, axis=-1) < thr) & (depth > 0) & valid)
    R, tv = j_refine(R, tv, p3, p2, K, w2.astype(jnp.float32), iters=iters)
    proj, depth = j_project(p3, R, tv, K)
    inliers = (jnp.linalg.norm(proj - p2, axis=-1) < thr) & (depth > 0) & valid
    return R, tv, inliers


def test_pnp_refine_plain_matches_jax_refits():
    # R within 1e-4 rad, t within 1e-4 |t|, inliers equal (LU on both sides
    # here; the kernel's Cholesky is held against this twin on the card).
    rng = np.random.default_rng(21)
    R0, t0, p3, p2, valid = pnp_scene(rng)
    ok0 = np.array([True, False, True])
    got = tpnp.pnp_refine_plain(t(R0), t(t0), t(ok0), t(p3), t(p2), t(valid), t(K_NP), 8.0,
                                torch.full((3,), 15), 10)
    for b in range(3):
        R, tv, inl = jax_pnp_refit(R0[b], t0[b], p3[b], p2[b], valid[b], ok0[b])
        assert rot_angle(n(got["R"][b]), R) <= 1e-4
        assert np.linalg.norm(n(got["t"][b]) - n(tv)) <= 1e-4 * np.linalg.norm(n(tv))
        np.testing.assert_array_equal(n(got["inliers"][b]), n(inl))
        assert int(got["num_inliers"][b]) == int(n(inl).sum()) > 100
    assert n(got["ok"]).all()


def test_pnp_ransac_batch_goes_through_pnp_refine():
    # The wrapper's dict is the twin's on a CPU tensor, whatever the winner.
    rng = np.random.default_rng(22)
    R0, t0, p3, p2, valid = pnp_scene(rng, B=2, N=300)
    idx = torch.as_tensor(rng.integers(0, 150, (2, 64, 3)))
    out = tpnp.pnp_ransac_batch(t(p3), t(p2), t(valid), t(K_NP), torch.full((2,), 15),
                                iters=64, indices=idx)
    assert set(out) == {"R", "rvec", "t", "inliers", "num_inliers", "errors", "ok"}
    assert n(out["ok"]).all() and (n(out["num_inliers"]) > 100).all()


# ------------------------------------------------------------------ K2


def _samples(rng, valid_n, B, H):
    return rng.integers(0, valid_n, (B, H, 8))


def _well_conditioned(p1, p2, idx):
    """lambda_2 >= 1e-3 lambda_max of each sample's normalized 9x9 A^T A (f64)."""
    def norm(p):
        c = p.mean(-2, keepdims=True)
        s = np.sqrt(2) / np.linalg.norm(p - c, axis=-1).mean(-1)[..., None, None]
        return (p - c) * s
    a, b = norm(p1[idx].astype(np.float64)), norm(p2[idx].astype(np.float64))
    x1, y1, x2, y2 = a[..., 0], a[..., 1], b[..., 0], b[..., 1]
    A = np.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, np.ones_like(x1)], -1)
    lam = np.linalg.eigvalsh(np.swapaxes(A, -1, -2) @ A)
    return lam[..., 1] >= 1e-3 * lam[..., -1]


def test_fmat_hypotheses_plain_matches_jax():
    # Sign-aligned within 1e-4 on the well-conditioned samples (their null
    # vector's f32 rounding is ~eps lambda_max / lambda_2 <= 6e-5).
    rng = np.random.default_rng(23)
    p1, p2 = two_view(rng)
    idx = _samples(rng, len(p1), 1, 512)
    got = n(tfm.fmat_hypotheses_plain(t(p1)[None], t(p2)[None], torch.as_tensor(idx))[0])
    ref = n(jax.vmap(lambda a, b: j_eight_point(a, b, enforce_rank2=False, null_iters=3,
                                                null_fallback=False))(p1[idx[0]], p2[idx[0]]))
    well = _well_conditioned(p1, p2, idx[0])
    d = np.minimum(np.abs(got - ref).reshape(-1, 9).max(1),
                   np.abs(got + ref).reshape(-1, 9).max(1))
    assert well.sum() > 50
    assert (d[well] <= 1e-4).mean() >= 0.99, np.sort(d[well])[-10:]


def jax_refit_verify(Fs, best, p1, p2, valid, thr=3.0, min_inliers=15, min_ratio=0.3,
                     max_err=2.0, min_spread=20.0):
    """estimate_fundamental_ransac after ransac_select, then verify_pair's
    gates (sfm_tpu/estimators/fundamental.py:80-86, matching/verify.py:50-83)."""
    ok = valid.sum() >= 8
    w = ((j_sym(Fs[best], p1, p2) < thr) & valid).astype(jnp.float32)
    F = j_eight_point(p1, p2, w)
    err = j_sym(F, p1, p2)
    inl = (err < thr) & valid & ok
    wi = inl.astype(jnp.float32)
    n_m, n_i = valid.sum(), inl.sum()
    ratio = n_i / max(n_m, 1)
    mean_err = jnp.where(inl, err, 0.0).sum() / jnp.maximum(n_i, 1)
    spread = all(j_masked_std(x, wi) > min_spread
                 for x in (p1[:, 0], p1[:, 1], p2[:, 0], p2[:, 1]))
    accept = ok & (n_i >= min_inliers) & (ratio >= min_ratio) & (mean_err <= max_err) & spread
    return {"F": F, "inliers": inl, "num_matches": n_m, "num_inliers": n_i,
            "inlier_ratio": ratio, "reprojection_error": mean_err,
            "well_distributed": spread, "accept": accept, "ok": ok}


@pytest.mark.parametrize("case", ["good", "noise", "concentrated"])
def test_fmat_refit_verify_plain_matches_jax(case):
    # The cases of test_torch_matching.py::test_verify_pair_gates_match_jax,
    # both sides given JAX's hypotheses and winner. Good: F sign-aligned
    # within 1e-4, inliers equal, ratio and mean error within 1e-4. The
    # degenerate sets' refit is ill-conditioned: the verdict must agree, the
    # inlier count within 3.
    rng = np.random.default_rng(13)
    p1, p2 = two_view(rng)
    if case == "noise":
        p2 = rng.uniform([0, 0], [1024, 768], p2.shape).astype(np.float32)
    if case == "concentrated":
        p1 = (p1 - p1.mean(0)) * 0.02 + 500
        p2 = (p2 - p2.mean(0)) * 0.02 + 400
    valid = np.ones(len(p1), bool)
    idx = _samples(rng, len(p1), 1, 256)[0]
    Fs = jax.vmap(lambda a, b: j_eight_point(a, b, enforce_rank2=False, null_iters=3,
                                             null_fallback=False))(p1[idx], p2[idx])
    errs = jax.vmap(j_sym, in_axes=(0, None, None))(Fs, p1[:128], p2[:128])
    best = int(j_select(errs, jnp.asarray(valid[:128]), 3.0)[0])
    ref = jax_refit_verify(Fs, best, jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(valid))
    got = tfm.fmat_refit_verify_plain(t(n(Fs))[None], torch.tensor([best]), t(p1)[None],
                                      t(p2)[None], t(valid)[None], 3.0)
    for k in ("accept", "well_distributed", "num_matches", "ok"):
        assert n(got[k][0]) == n(ref[k]), k
    assert bool(got["accept"][0]) == (case == "good")
    if case == "good":
        F, Fr = n(got["F"][0]), n(ref["F"])
        assert min(np.abs(F - Fr).max(), np.abs(F + Fr).max()) <= 1e-4
        np.testing.assert_array_equal(n(got["inliers"][0]), n(ref["inliers"]))
        for k in ("inlier_ratio", "reprojection_error"):
            np.testing.assert_allclose(n(got[k][0]), n(ref[k]), rtol=1e-4, atol=1e-5)
    else:
        assert abs(int(got["num_inliers"][0]) - int(ref["num_inliers"])) <= 3


def _rank2_by_adjugate(F):
    """fmat_solve.cu's rank 2 in torch: F (I - v v^T), v the smallest
    eigenvector of F^T F, the dominant one of its 3x3 adjugate, taken as the
    largest column of the adjugate raised to the power 4096 by squaring."""
    P = _adjugate3(F.mT @ F)
    for _ in range(12):
        P = P @ P
        P = P / P.abs().amax((-2, -1), keepdim=True).clamp(min=1e-30)
    norms = torch.linalg.vector_norm(P, dim=-2)
    v = torch.gather(P, -1, norms.argmax(-1)[..., None, None].expand(F.shape[:-2] + (3, 1)))
    v = v[..., 0] / norms.amax(-1, keepdim=True).clamp(min=1e-30)
    return F - (F @ v[..., None]) * v[..., None, :]


def test_rank2_projection_equals_svd_truncation():
    # F (I - v v^T) is the SVD truncation whatever signs an SVD picks: to
    # 1e-6 (f64) on random F with sigma_3 <= 0.95 sigma_2 and on eight-point
    # fits with and without outliers, in normalized coordinates (where the
    # kernel truncates) and in pixels.
    rng = np.random.default_rng(24)
    U, _ = np.linalg.qr(rng.normal(size=(200, 3, 3)))
    V, _ = np.linalg.qr(rng.normal(size=(200, 3, 3)))
    s2 = rng.uniform(0.2, 1.0, 200)
    S = np.stack([np.ones(200), s2, s2 * rng.uniform(0.0, 0.95, 200)], -1)
    F = torch.as_tensor(U * S[:, None] @ V.transpose(0, 2, 1))
    p1, p2 = (t(p) for p in two_view(rng))
    n1, n2 = normalize_points(p1)[0], normalize_points(p2)[0]
    fits = torch.stack([tfm.eight_point(a, b, enforce_rank2=False).double()
                        for a, b in ((n1, n2), (n1[:40], n2[:40]), (p1, p2))])
    for Fb in (F, fits):
        u, s, vh = torch.linalg.svd(Fb)
        ref = u @ (torch.cat([s[..., :2], torch.zeros_like(s[..., 2:])], -1)[..., None] * vh)
        assert float((_rank2_by_adjugate(Fb) - ref).abs().max()) <= 1e-6


# ------------------------------------------------------------------ K4


@pytest.mark.parametrize("shape,budget", [((3, 37, 45), 64), ((3, 64, 80), 256),
                                          ((2, 21, 19), 200)])
def test_select_octave_candidates_with_planted_ties(shape, budget):
    # Identical (layer, y, x, score) in the same order: ties go to the lower
    # index at every level (lax.top_k), across blocks and within cells.
    rng = np.random.default_rng(25)
    score = rng.choice(np.float32([0.0, 0.25, 0.5, 1.0]), size=shape, p=[0.85, 0.07, 0.05, 0.03])
    score[0, 10:14, 10:14] = 0.5                        # a block of equal cells
    score[-1, :2, -2:] = 1.0                            # a cell of equal pixels
    ref = jdet.select_octave_candidates({"score": jnp.asarray(score)}, budget)
    got = tdet.select_octave_candidates({"score": t(score)[None]}, budget)
    for k in ("layer", "y", "x", "score"):
        np.testing.assert_array_equal(n(got[k][0]), n(ref[k]), err_msg=k)
    assert (n(got["score"][0]) > 0).sum() > budget // 4


def test_dog_refine_plain_masks_padding():
    # dog_refine's twin is refine_and_gate with selection padding (score 0)
    # forced invalid, the frontend's mask.
    rng = np.random.default_rng(26)
    dog = t(rng.normal(0, 0.05, (1, 5, 24, 30)).astype(np.float32))
    layer, y, x = (torch.as_tensor(rng.integers(1, hi, (1, 50))) for hi in (4, 23, 29))
    cand = t((rng.random((1, 50)) > 0.3).astype(np.float32))
    ox, oy, os_, g = tdet.dog_refine(dog, layer, y, x, cand, 0.01, 10.0)
    rx, ry, rs, rg = tdet.refine_and_gate(dog, layer, y, x, 0.01, 10.0)
    for a, b in ((ox, rx), (oy, ry), (os_, rs)):
        assert torch.equal(a, b)
    assert torch.equal(g, torch.where(cand > 0, rg, 0.0)) and bool((rg[cand == 0] > 0).any())


def test_top_k_twin_is_lax_top_k():
    # Ties to the lower index, -inf and -1 rows included (the frontend's and
    # the sweep's inputs), identical to jax.lax.top_k.
    rng = np.random.default_rng(27)
    x = np.round(rng.random((4, 300)) * 20).astype(np.float32) / 20
    x[rng.random((4, 300)) < 0.3] = -1.0
    x[rng.random((4, 300)) < 0.2] = -np.inf
    vk, ik = tran.top_k(t(x), 120)
    vj, ij = jax.lax.top_k(jnp.asarray(x), 120)
    np.testing.assert_array_equal(n(vk), n(vj))
    np.testing.assert_array_equal(n(ik), n(ij))


# ------------------------------------------------------------------ K10


def _port_lin(ref):
    """The JAX Linearization's arrays as the port's (the same system)."""
    return tschur.Linearization(**{f: t(np.asarray(getattr(ref, f)))
                                   for f in tschur.Linearization._fields})


def test_schur_damp_and_back_substitute_plain_match_jax(rng):
    # 1e-5 of each tensor's largest entry, on the same linearization.
    prob = perturbed_problem(rng, n_cams=7, n_pts=90)
    ref, _, _ = jax_linearization(prob)
    lin = _port_lin(ref)
    perm, pvm = (torch.as_tensor(a) for a in tschur.coobs_pairs(np.asarray(prob.obs_point),
                                                                 np.asarray(prob.obs_valid)))
    op_j, rhs_cj, rhs_kj, _ = j_damp(ref, jnp.float32(1e-3))
    op, rhs_c, rhs_k = tschur.damp_operator(lin, 1e-3, perm, pvm)

    def rel(a, b, tol=1e-5):
        a, b = n(a), n(b)
        assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-30)

    for a, b in ((op.Vinv, op_j.Vinv), (op.lam_diag_c, op_j.lam_diag_c),
                 (op.lam_diag_k, op_j.lam_diag_k), (rhs_c, rhs_cj), (rhs_k, rhs_kj)):
        rel(a, b)
    xc = rng.normal(0, 1e-2, (7, 6)).astype(np.float32)
    xk = rng.normal(0, 1e-1, 4).astype(np.float32)
    rel(tschur.back_substitute(lin, op, t(xc), t(xk), perm, pvm),
        j_back(op_j, ref.g_p, jnp.asarray(xc), jnp.asarray(xk)))


# ------------------------------------------------------------------ wrappers


def _meta(*s, **k):
    return torch.empty(s, device="meta", **k)


def test_new_wrappers_run_their_twin_on_cpu_and_refuse_other_devices():
    m, b = _meta, torch.bool
    cases = [
        lambda: tpnp.pnp_refine(m(2, 3, 3), m(2, 3), m(2, dtype=b), m(2, 9, 3), m(2, 9, 2),
                                m(2, 9, dtype=b), m(3, 3), 8.0, 15),
        lambda: tfm.fmat_ransac(m(2, 9, 2), m(2, 9, 2), m(2, 9, dtype=b),
                                m(2, 4, 8, dtype=torch.int64), 3.0),
        lambda: tdet.select_octave_candidates({"score": m(1, 3, 16, 16)}, 8),
        lambda: tdet.dog_refine(m(1, 5, 16, 16), *(m(1, 8, dtype=torch.int64),) * 3,
                                m(1, 8), 0.01, 10.0),
        lambda: tran.top_k(m(2, 9), 3),
    ]
    for fn in cases:
        with pytest.raises(ValueError, match="device"):
            fn()
    lin = tschur.Linearization(*([None] * 7), U=m(2, 6, 6), Uk=None, g_c=None, g_k=None,
                               g_p=None, point_valid=None)
    with pytest.raises(ValueError, match="device"):
        tschur.damp_operator(lin, 1e-3, None, None)
    with pytest.raises(ValueError, match="device"):
        tschur.back_substitute(lin, None, m(2, 6), m(4), None, None)
    # On CPU tensors each wrapper is its twin.
    rng = np.random.default_rng(28)
    p1, p2 = two_view(rng, n_pts=64)
    idx = torch.as_tensor(rng.integers(0, 64, (1, 16, 8)))
    P1, P2 = t(p1)[None], t(p2)[None]
    v = torch.ones(1, 64, dtype=b)
    a, c = tfm.fmat_ransac(P1, P2, v, idx, 3.0, 32), tfm.fmat_ransac_plain(P1, P2, v, idx, 3.0, 32)
    assert all(torch.equal(a[k], c[k]) for k in c)
    assert torch.equal(a["Fs"], tfm.fmat_hypotheses_plain(P1, P2, idx))
    score = t(rng.random((2, 3, 20, 24)).astype(np.float32))
    a, c = tdet.select_octave_candidates({"score": score}, 30), \
        tdet.select_octave_candidates_plain({"score": score}, 30)
    assert all(torch.equal(a[k], c[k]) for k in c)


def test_new_kernel_wrappers_refuse_shapes_beyond_their_limits():
    m, b = _meta, torch.bool
    with pytest.raises(ValueError, match="exceeds"):
        tpnp.pnp_refine_cuda(m(1, 3, 3), m(1, 3), m(1, dtype=b), m(1, 8193, 3), m(1, 8193, 2),
                             m(1, 8193, dtype=b), m(3, 3), 8.0, 15)
    with pytest.raises(ValueError, match="exceeds"):
        tfm.fmat_ransac_cuda(m(1, 1025, 2), m(1, 1025, 2), m(1, 1025, dtype=b),
                             m(1, 4, 8, dtype=torch.int64), 3.0)
    with pytest.raises(ValueError, match="budget"):
        tdet.select_octave_candidates_cuda({"score": m(1, 3, 16, 16)}, 20000)
    with pytest.raises(ValueError, match="exceeds"):
        tran.top_k_cuda(m(2, 40000), 20000)
