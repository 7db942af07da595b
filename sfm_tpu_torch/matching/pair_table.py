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
