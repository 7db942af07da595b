"""The port's DLT PnP branch (``pnp.sample_size != 3``) against the JAX
package, and the camera counts that K10, K11 and K13 take.

``pnp_dlt`` and the per-hypothesis Gauss-Newton step against
``sfm_tpu.estimators.pnp`` on numpy-seeded scenes; ``pnp_ransac_batch``'s DLT
branch with JAX's own sample indices injected; the wrappers' device rules;
and the route each BA kernel of the island takes for its camera sums, and
K13's state, at and past the old shared-memory caps (the wrappers' launch
arguments, recorded in place of a launch: there is no card here). The
8-view ``reconstruct`` at sample size 6 through both packages is in
``tests/test_torch_slice.py``. Tolerances beside each check.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from torch_parity import n, t

from sfm_tpu.estimators.pnp import _gn_sample_step as j_gn_sample_step
from sfm_tpu.estimators.pnp import pnp_dlt as j_pnp_dlt
from sfm_tpu.estimators.pnp import pnp_ransac as j_pnp_ransac
from sfm_tpu.estimators.ransac import ransac_sample_indices as j_sample
from sfm_tpu.geometry import rotation_to_rvec as j_rotation_to_rvec
from sfm_tpu_torch import _kernels
from sfm_tpu_torch.ba import schur as tschur
from sfm_tpu_torch.estimators import pnp as tpnp
from sfm_tpu_torch.reconstruction import global_init as tgi

K = np.array([[1228.0, 0, 512.0], [0, 1228.0, 384.0], [0, 0, 1]], np.float32)
ROUTES = [(6, torch.float32), (10, torch.float32), (6, torch.float64), (10, torch.float64)]


def angle(Ra, Rb):
    return float(np.arccos(np.clip((np.trace(np.asarray(Ra).T @ np.asarray(Rb)) - 1) / 2,
                                   -1, 1)))


def camera(rng, flip=False):
    """A pose that puts the unit cube 5-7 units in front. ``flip``: a half
    turn about the optical axis with t's x, y negative, so the entries of
    [R | t] sum below 0 and inverse iteration from x0 ~ (1, ..., 1) returns
    the DLT null vector with its negative sign: -P's decomposition wins."""
    if flip:
        R = Rotation.from_rotvec([0.0, 0.0, np.pi - 0.1]).as_matrix()
        tv = np.array([-3.0, -3.0, 5.0])
        assert np.concatenate([R, tv[:, None]], 1).sum() < 0
    else:
        R = Rotation.from_rotvec(rng.normal(0, 0.2, 3)).as_matrix()
        tv = rng.uniform([-0.5, -0.5, 5], [0.5, 0.5, 7], 3)
    return R.astype(np.float32), tv.astype(np.float32)


# ------------------------------------------------------------------- pnp_dlt

DLT_CASES = {f"{noise}_{w}_{fb}": (noise, w, fb) for noise in ("exact", "noisy")
             for w in ("unweighted", "weighted") for fb in ("fallback", "no_fallback")}
DLT_CASES["sign_flip"] = ("noisy", "weighted", "no_fallback")


@pytest.mark.parametrize("case", list(DLT_CASES))
def test_pnp_dlt_matches_jax(case):
    # Tolerance: R and t within 1e-4 of JAX's (float32, the same steps; the
    # normal matrix's sums and the 12 x 12 factorization round in another
    # order); both near the true pose (1e-2 rad, 1e-2 of |t|) on exact data
    # and with 0.25 px of noise (2e-4 in normalized coordinates) on 30 points.
    noise, w, fb = DLT_CASES[case]
    rng = np.random.default_rng(sorted(DLT_CASES).index(case))
    R, tv = camera(rng, flip=case == "sign_flip")
    N = 30
    p3 = rng.uniform(-1, 1, (N, 3)).astype(np.float32)
    xc = p3 @ R.T + tv
    pn = (xc[:, :2] / xc[:, 2:]).astype(np.float32)
    if noise == "noisy":
        pn = (pn + rng.normal(0, 2e-4, pn.shape)).astype(np.float32)
    wt = rng.uniform(0.5, 1.0, N).astype(np.float32) if w == "weighted" else None
    Rj, tj = j_pnp_dlt(p3, pn, wt, null_fallback=fb == "fallback")
    Rt, tt = tpnp.pnp_dlt(t(p3), t(pn), None if wt is None else t(wt),
                          null_fallback=fb == "fallback")
    np.testing.assert_allclose(n(Rt), np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(n(tt), np.asarray(tj), atol=1e-4 * np.abs(np.asarray(tj)).max())
    assert angle(n(Rt), R) < 1e-2
    assert np.linalg.norm(n(tt) - tv) < 1e-2 * np.linalg.norm(tv)


def test_pnp_dlt_batched_matches_one_by_one(rng):
    # Leading batch dimensions give each entry's own solve (to f32 rounding).
    p3 = rng.uniform(-1, 1, (2, 3, 8, 3)).astype(np.float32)
    p2 = rng.normal(0, 0.2, (2, 3, 8, 2)).astype(np.float32)
    Rb, tb = tpnp.pnp_dlt(t(p3), t(p2), null_fallback=False)
    for i in range(2):
        for j in range(3):
            R1, t1 = tpnp.pnp_dlt(t(p3[i, j]), t(p2[i, j]), null_fallback=False)
            np.testing.assert_allclose(n(Rb[i, j]), n(R1), atol=1e-5)
            np.testing.assert_allclose(n(tb[i, j]), n(t1), atol=1e-5)


def test_gn_sample_step_matches_jax(rng):
    # Two steps from a perturbed pose on 6-point samples: the port's
    # batched step against JAX's one sample at a time. Tolerance: 1e-4
    # relative to the parameters' scale (jacfwd on both sides, LU solves).
    R, tv = camera(rng)
    S, H = 6, 5
    p3 = rng.uniform(-1, 1, (H, S, 3)).astype(np.float32)
    xc = p3 @ R.T + tv
    p2 = ((xc @ K.T)[..., :2] / (xc @ K.T)[..., 2:] + rng.normal(0, 0.5, (H, S, 2)))
    p2 = p2.astype(np.float32)
    R0 = (Rotation.from_rotvec(rng.normal(0, 0.01, (H, 3))).as_matrix() @ R).astype(np.float32)
    t0 = (tv * (1 + rng.normal(0, 0.01, (H, 3)))).astype(np.float32)
    rv = np.stack([np.asarray(j_rotation_to_rvec(r)) for r in R0])
    got = tpnp._gn_sample_step(t(rv), t(t0), t(p3), t(p2), t(K))
    got = tpnp._gn_sample_step(got[:, :3], got[:, 3:], t(p3), t(p2), t(K))
    for h in range(H):
        ref = j_gn_sample_step(jnp.asarray(rv[h]), jnp.asarray(t0[h]), p3[h], p2[h], K)
        ref = j_gn_sample_step(ref[:3], ref[3:], p3[h], p2[h], K)
        np.testing.assert_allclose(n(got[h]), np.asarray(ref),
                                   atol=1e-4 * max(1.0, np.abs(np.asarray(ref)).max()))


# --------------------------------------------------------- the RANSAC branch

def pnp_scene(rng, N=300, n_valid=260, outliers=0.3):
    R, tv = camera(rng)
    p3 = rng.uniform(-2, 2, (N, 3)).astype(np.float32)
    xc = p3 @ R.T + tv
    p2 = ((xc @ K.T)[:, :2] / (xc @ K.T)[:, 2:] + rng.normal(0, 0.5, (N, 2))).astype(np.float32)
    out = rng.random(N) < outliers
    p2[out] = rng.uniform([0, 0], [1024, 768], (out.sum(), 2))
    valid = np.arange(N) < n_valid
    return p3 * valid[:, None], p2 * valid[:, None], valid, R, tv


@pytest.mark.parametrize("sample_size", [6, 8])
def test_pnp_ransac_dlt_with_jax_sample_indices(rng, sample_size):
    # Tolerance: pose within 1e-3 rad and 1e-3 relative translation, inlier
    # counts within 1, the same ok (the same hypotheses to f32 rounding; the
    # refits sum in another order).
    for seed in range(2):
        p3, p2, valid, R_gt, t_gt = pnp_scene(rng)
        key = jax.random.key(100 * sample_size + seed)
        ref = j_pnp_ransac(key, p3, p2, valid, K, iters=256, threshold=8.0, min_inliers=15,
                           refine_iters=10, sample_size=sample_size)
        idx = np.asarray(j_sample(key, valid, 256, sample_size, prefix=True))
        got = tpnp.pnp_ransac(t(p3), t(p2), t(valid), t(K), iters=256, threshold=8.0,
                              min_inliers=15, refine_iters=10, sample_size=sample_size,
                              indices=torch.as_tensor(idx).long())
        assert angle(n(got["R"]), np.asarray(ref["R"])) <= 1e-3
        tj = np.asarray(ref["t"])
        assert np.linalg.norm(n(got["t"]) - tj) <= 1e-3 * np.linalg.norm(tj)
        assert abs(int(got["num_inliers"]) - int(ref["num_inliers"])) <= 1
        assert bool(got["ok"]) == bool(ref["ok"]) is True
        assert angle(n(got["R"]), R_gt) < 5e-3


def test_dlt_hypotheses_match_jax(rng):
    # The twin of the kernel's whole launch (DLT, decomposition, two GN
    # steps) against JAX's branch on the same samples, 30% outliers. Most
    # samples hold an outlier, and such a junk pose is chaotic under
    # rounding: the GN system's 1e-4 damping is ~1e-10 of J^T J in f32, and
    # JAX and the twin, the same algorithm, agree within 1e-2 on only
    # ~89-90% of the hypotheses. Held, as chip_smoke.py holds the kernel:
    # >= 90% within 1e-2 of the pose, counting a hypothesis that scores no
    # consensus (< 15 inliers) on both sides as agreeing, since RANSAC
    # discards it either way; and every hypothesis with a consensus on
    # either side within 1e-2 on >= 95% of them.
    from sfm_tpu.geometry import rodrigues
    from sfm_tpu_torch.geometry.projection import project

    p3, p2, _, _, _ = pnp_scene(rng, N=200, n_valid=200)
    S, H = 6, 512
    idx = rng.integers(0, 200, (H, S))
    pn = (np.concatenate([p2, np.ones_like(p2[:, :1])], 1) @ np.linalg.inv(K).T)[:, :2]
    pn = pn.astype(np.float32)
    Rs, ts = tpnp.pnp_dlt_solve(t(p3[None]), t(pn[None]), t(p2[None]),
                                torch.as_tensor(idx[None]), t(K))

    def one(s3, s2n, s2):
        R0, t0 = j_pnp_dlt(s3, s2n, null_fallback=False)
        prm = j_gn_sample_step(j_rotation_to_rvec(R0), t0, s3, s2, K)
        prm = j_gn_sample_step(prm[:3], prm[3:], s3, s2, K)
        return rodrigues(prm[:3]), prm[3:]

    Rj, tj = (np.asarray(a) for a in jax.jit(jax.vmap(one))(p3[idx], pn[idx], p2[idx]))
    Rk, tk = n(Rs[0]), n(ts[0])
    close = ((np.abs(Rk - Rj).max((1, 2)) <= 1e-2)
             & (np.abs(tk - tj).max(1) <= 1e-2 * np.maximum(1.0, np.abs(tj).max(1))))

    def consensus(R, tv):
        pr, dep = project(t(p3)[None], t(R)[:, None], t(tv)[:, None], t(K))
        return n(((pr - t(p2)[None]).norm(dim=-1) < 8.0) & (dep > 0)).sum(-1)

    ck, cj = consensus(Rk, tk), consensus(Rj, tj)
    junk = (ck < 15) & (cj < 15)
    assert (close | junk).mean() >= 0.9, ((close | junk).mean(), close.mean())
    assert close[~junk].mean() >= 0.95, close[~junk].mean()
    assert (~junk).sum() >= 0.05 * H    # the all-inlier samples give consensus


def test_dlt_wrappers_by_device(monkeypatch):
    # CPU tensors take the twin; a CUDA tensor only the kernel (its launch
    # recorded here: no card); any other device is refused.
    m = lambda *s, **k: torch.empty(s, device="meta", **k)
    with pytest.raises(ValueError, match="device"):
        tpnp.pnp_dlt_solve(m(1, 8, 3), m(1, 8, 2), m(1, 8, 2), m(1, 4, 6, dtype=torch.int64),
                           m(3, 3))
    calls = []
    monkeypatch.setattr(_kernels, "launch", lambda name, dev, *a: calls.append((name, a)))
    Rs, ts = tpnp.pnp_dlt_solve_cuda(m(2, 8, 3), m(2, 8, 2), m(2, 8, 2),
                                     m(2, 4, 6, dtype=torch.int32), m(3, 3))
    assert [c[0] for c in calls] == ["pnp_dlt_solve"] and calls[0][1][5:9] == (2, 4, 6, 8)
    assert Rs.shape == (2, 4, 3, 3) and ts.shape == (2, 4, 3)
    # Any sample size the reference takes (it runs its DLT on any size but 3).
    tpnp.pnp_dlt_solve_cuda(m(2, 8, 3), m(2, 8, 2), m(2, 8, 2),
                            m(2, 4, 5, dtype=torch.int32), m(3, 3))
    assert calls[1][1][7] == 5
    with pytest.raises(TypeError, match="dtype"):   # int64 indices go through the dispatcher
        tpnp.pnp_dlt_solve_cuda(m(2, 8, 3), m(2, 8, 2), m(2, 8, 2),
                                m(2, 4, 6, dtype=torch.int64), m(3, 3))


# -------------------------------------------------- camera counts: no caps

def _system(C, B, dt, P=4, O=8, G=4, Vs=2):
    m = lambda *s, dtype=dt: torch.empty(s, device="meta", dtype=dtype)
    lin = tschur.Linearization(
        Jc=m(O, 2, B), Jk=m(O, 2, 4), Jp=m(O, 2, 3), rw=m(O, 2),
        obs_cam=m(O, dtype=torch.int32), obs_point=m(O, dtype=torch.int32), V=m(P, 3, 3),
        U=m(C, B, B), Uk=m(4, 4), g_c=m(C, B), g_k=m(4), g_p=m(P, 3),
        point_valid=m(P, dtype=torch.bool), Hreg_k=m(4, 4),
        U_extra=m(C, B, B) if B == 10 else None)
    op = tschur.Damped(Vinv=m(P, 3, 3), lam_diag_c=m(C, B), lam_diag_k=m(4))
    return lin, op, m(G, Vs, dtype=torch.int32), m(G, Vs, dtype=torch.bool), m


@pytest.mark.parametrize("B,dt", ROUTES, ids=["b6_f32", "b10_f32", "b6_f64", "b10_f64"])
def test_camera_sums_route_at_the_shared_memory_limit(monkeypatch, B, dt):
    # Up to max_cameras a block of K10's rhs walk stages its camera sums in
    # shared memory, above it they go to global memory; the wrapper passes
    # that choice. K11's matvec adds its camera-major runs straight into
    # the global words at any camera count. No count is refused.
    cap = tschur.max_cameras(B, dt)
    assert tschur.camera_sums_in_shared(cap, B, dt)
    assert not tschur.camera_sums_in_shared(cap + 1, B, dt)
    calls = []
    monkeypatch.setattr(_kernels, "launch", lambda name, dev, *a: calls.append((name, a)))
    Ov, R = 8, 4
    for C in (cap, cap + 1):
        lin, op, perm, perm_valid, m = _system(C, B, dt)
        i32 = lambda *s: m(*s, dtype=torch.int32)
        work = tschur.MatvecWork(walk=i32(Ov), row_start=i32(R + 1), cam_walk=i32(Ov),
                                 cam_of=i32(Ov), terms=m((B + 4) * Ov), gmax=i32(B * C + 4),
                                 ctrl=i32(2), acc=m(tschur._words(dt) * (B * C + 4),
                                                    dtype=torch.int64))
        tschur.schur_damp_cuda(lin, 1e-3, perm, perm_valid)
        tschur.schur_matvec_cuda(lin, op, m(C, B), m(4), perm, perm_valid, work)
    route = tschur.variant(B, dt)
    assert [c[0] for c in calls] == [f"schur_damp{route}", f"schur_matvec{route}"] * 2
    # schur_damp: (..., P, C, G, Vs, O, in_shared, lam, ...); schur_matvec:
    # (..., x, walk, row_start, cam_walk, cam_of, C, G, Vs, R, Ov, flag, ...).
    assert [c[1][13] for c in calls[::2]] == [cap, cap + 1]
    assert [c[1][17] for c in calls[::2]] == [1, 0]
    assert [c[1][14:19] for c in calls[1::2]] == [(cap, 4, 2, R, Ov), (cap + 1, 4, 2, R, Ov)]


@pytest.mark.parametrize("which", ["rotation", "translation"])
def test_averaging_takes_any_camera_count(monkeypatch, which):
    # K13-b/c keep their state in shared memory up to 1,024 cameras and in a
    # global scratch (25 N / 21 N floats) above; no count is refused.
    calls = []
    monkeypatch.setattr(_kernels, "launch", lambda name, dev, *a: calls.append((name, a)))
    m = lambda *s, **k: torch.empty(s, device="meta", **k)
    for N in (1024, 1025, 2000):
        P = 3 * N
        if which == "rotation":
            tgi.rotation_average_cuda(m(P, 2, dtype=torch.int32), m(P, 3, 3), m(P), m(3 * N, 3))
        else:
            tgi.translation_average_cuda(m(P, 2, dtype=torch.int32), m(P, 3), m(P), m(N, 3))
    per_cam = 25 if which == "rotation" else 21
    states = [c[1][-2] for c in calls]
    assert states[0] is None
    assert [s.shape for s in states[1:]] == [(per_cam * 1025,), (per_cam * 2000,)]
