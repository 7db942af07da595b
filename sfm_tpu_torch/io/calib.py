"""Ground-truth calibration files and pose evaluation: the port's copy of
``sfm_tpu/io/calib.py``.

Reads the CONTOUR-format 3x4 projection matrices (``calib/NNNN.txt``) and
evaluates a reconstruction against them (Umeyama alignment, rotation and
translation errors). ``tests/test_torch_host_copies.py`` holds it against the
original.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np


def load_projection_matrix(path) -> np.ndarray:
    """Parse a CONTOUR-format file into a (3, 4) float64 projection matrix."""
    lines = [ln.strip() for ln in Path(path).read_text().splitlines() if ln.strip()]
    if lines and not lines[0][0].isdigit() and not lines[0].lstrip("-")[0].isdigit():
        lines = lines[1:]  # drop the "CONTOUR" header
    rows = [[float(v) for v in ln.split()] for ln in lines[:3]]
    P = np.array(rows, dtype=np.float64)
    if P.shape != (3, 4):
        raise ValueError(f"expected 3x4 projection matrix in {path}, got {P.shape}")
    return P


def decompose_projection(P: np.ndarray):
    """P = K [R | t] -> (K, R, t) with K upper-triangular, positive diagonal.

    RQ decomposition via the flipped-QR trick; enforces det(R) = +1 and
    K[2,2] = 1.
    """
    if np.linalg.det(P[:, :3]) < 0:
        P = -P  # projective scale; guarantees det(R) = +1 after the sign fix
    M = P[:, :3]
    # RQ(M): flip, QR, flip back.
    Mf = np.flipud(M).T
    Q, R_ = np.linalg.qr(Mf)
    K = np.flipud(np.fliplr(R_.T))
    R = np.flipud(Q.T)
    # Make K's diagonal positive.
    sgn = np.sign(np.diag(K))
    sgn[sgn == 0] = 1.0
    S = np.diag(sgn)
    K = K @ S
    R = S @ R
    t = np.linalg.solve(K, P[:, 3])
    K = K / K[2, 2]
    return K, R, t


def load_gt_poses(calib_dir):
    """All ground-truth (K, R, t) in a calib/ dir, keyed by image index.

    File stems are zero-padded image indices (bunny: 0000.txt..0035.txt).
    """
    poses = {}
    for f in sorted(Path(calib_dir).glob("*.txt")):
        try:
            idx = int(f.stem)
        except ValueError:
            continue
        K, R, t = decompose_projection(load_projection_matrix(f))
        poses[idx] = (K, R, t)
    return poses


def evaluate_result_against_gt(calib_dir, result, image_names=None):
    """GT pose accuracy for a ReconstructionResult, mapping cameras by name.

    Engine image ids index the matcher's image list; GT files are keyed by
    filename stem. ``image_names`` (engine index -> image path or stem) makes
    that mapping explicit — required whenever the image range does not start
    at 0 or is non-contiguous (e.g. ``--start_idx 10``), where the bare
    engine index would silently compare camera 0 against calib 0000.
    Without it the engine index is used directly (valid only for 0-based
    contiguous ranges). Returns the evaluate_poses() dict or None when
    fewer than 3 registered cameras have GT.
    """
    gt = load_gt_poses(calib_dir)
    ids = np.asarray(result.image_ids)
    if image_names is not None:
        def _stem(idx):
            try:
                return int(Path(image_names[int(idx)]).stem)
            except (ValueError, IndexError):
                return None
        gt_ids = [_stem(i) for i in ids]
    else:
        gt_ids = [int(i) for i in ids]
    have = np.array([g is not None and g in gt for g in gt_ids], bool)
    if have.sum() < 3:
        return None
    R_gt = np.stack([gt[g][1] for g, h in zip(gt_ids, have) if h])
    t_gt = np.stack([gt[g][2] for g, h in zip(gt_ids, have) if h])
    return evaluate_poses(np.asarray(result.rotations)[have],
                          np.asarray(result.translations)[have], R_gt, t_gt)


def umeyama(src: np.ndarray, dst: np.ndarray):
    """Similarity (s, Q, T) minimizing ||dst - (s Q src + T)||^2 (Umeyama '91)."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    n = len(src)
    mu_s, mu_d = src.mean(0), dst.mean(0)
    src_c, dst_c = src - mu_s, dst - mu_d
    cov = dst_c.T @ src_c / n
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    Q = U @ S @ Vt
    var = (src_c ** 2).sum() / n
    s = float(np.trace(np.diag(D) @ S) / max(var, 1e-300))
    T = mu_d - s * Q @ mu_s
    return s, Q, T


def evaluate_poses(R_est, t_est, R_gt, t_gt):
    """Ground-truth pose accuracy after gauge (similarity) alignment.

    R_*: (N, 3, 3) world->cam rotations; t_*: (N, 3). Aligns estimated
    camera centers to GT centers with a Umeyama similarity, then reports
    per-camera rotation error (deg) and the camera-center ATE (RMSE in GT
    units, plus a scene-scale-relative variant). This grounds the quality
    claim in the calib/ ground truth the reference never reads
    (round-3 verdict next #9; self-consistency alone proves nothing about
    gauge-level drift).
    """
    R_est = np.asarray(R_est, np.float64)
    R_gt = np.asarray(R_gt, np.float64)
    t_est = np.asarray(t_est, np.float64)
    t_gt = np.asarray(t_gt, np.float64)
    C_est = -np.einsum("nji,nj->ni", R_est, t_est)
    C_gt = -np.einsum("nji,nj->ni", R_gt, t_gt)
    s, Q, T = umeyama(C_est, C_gt)
    d = (s * C_est @ Q.T + T) - C_gt
    ate = float(np.sqrt((d ** 2).sum(axis=1).mean()))
    extent = float(np.sqrt(((C_gt - C_gt.mean(0)) ** 2).sum(axis=1).mean()))
    # Estimated cam rotation expressed in the GT world frame: R_est Q^T.
    R_al = R_est @ Q.T
    tr = np.einsum("nij,nij->n", R_gt, R_al)  # trace(R_gt^T R_al)
    ang = np.degrees(np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0)))
    return {
        "n_eval": int(len(R_est)),
        "rot_err_deg_median": float(np.median(ang)),
        "rot_err_deg_max": float(ang.max()),
        "ate": ate,
        "ate_rel": float(ate / max(extent, 1e-300)),
    }
