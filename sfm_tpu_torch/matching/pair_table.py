"""``PairTable``: the verified-pair artifact of the sweep (host-side, numpy).

Counterpart of ``sfm_tpu/matching/sweep.py::PairTable`` (same fields and
methods). It lives in a module that imports numpy alone, so that the
``pair_table.pkl`` the preprocess stage writes unpickles without torch:
the JAX package's reconstruct stage reads it on a machine that has numpy
and this package's source, and nothing of torch.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class PairTable:
    """Verified-pair artifacts for a scene (host-side, numpy).

    Rows cover all candidate pairs; ``accept`` marks the verified ones.
    """

    pairs: np.ndarray               # (P, 2) int32 image indices (i < j)
    accept: np.ndarray              # (P,) bool
    num_matches: np.ndarray         # (P,) int32
    num_inliers: np.ndarray         # (P,) int32
    inlier_ratio: np.ndarray        # (P,) float32
    reprojection_error: np.ndarray  # (P,) float32
    well_distributed: np.ndarray    # (P,) bool
    F: np.ndarray                   # (P, 3, 3)
    xy1: np.ndarray                 # (P, M, 2) matched pixels in image i
    xy2: np.ndarray                 # (P, M, 2) matched pixels in image j
    idx1: np.ndarray                # (P, M) keypoint ids in image i
    idx2: np.ndarray                # (P, M) keypoint ids in image j
    match_valid: np.ndarray         # (P, M) bool
    inliers: np.ndarray             # (P, M) bool (subset of match_valid)

    @property
    def num_pairs(self) -> int:
        return int(self.pairs.shape[0])

    def accepted(self) -> np.ndarray:
        return np.nonzero(self.accept)[0]

    def to_records(self):
        """Accepted pairs as dicts: the matching_results.csv row schema."""
        rows = []
        for p in self.accepted():
            i, j = self.pairs[p]
            rows.append(
                {
                    "image1": int(i),
                    "image2": int(j),
                    "num_matches": int(self.num_matches[p]),
                    "num_inliers": int(self.num_inliers[p]),
                    "inlier_ratio": float(self.inlier_ratio[p]),
                    "reprojection_error": float(self.reprojection_error[p]),
                    "well_distributed": bool(self.well_distributed[p]),
                }
            )
        return rows


def rescue_disconnected(table: PairTable, num_images: int,
                        min_inliers: int = 8, min_ratio: float = 0.15) -> int:
    """Second-chance acceptance for images with no verified pair.

    Counterpart of ``sfm_tpu/matching/sweep.py::rescue_disconnected``: for
    each image with no accepted pair, re-admit its best pair (most inliers)
    that clears the relaxed gates. Mutates ``table.accept`` in place and
    returns the number of rescued pairs.
    """
    deg = np.zeros(num_images, np.int64)
    for p in table.accepted():
        i, j = table.pairs[p]
        deg[i] += 1
        deg[j] += 1
    if not table.accept.flags.writeable:
        table.accept = table.accept.copy()
    rescued = 0
    for img in np.nonzero(deg == 0)[0]:
        rows = np.nonzero(
            ((table.pairs[:, 0] == img) | (table.pairs[:, 1] == img))
            & ~table.accept
            & (table.num_inliers >= min_inliers)
            & (table.inlier_ratio >= min_ratio)
        )[0]
        if len(rows) == 0:
            continue
        table.accept[rows[np.argmax(table.num_inliers[rows])]] = True
        rescued += 1
    return rescued
