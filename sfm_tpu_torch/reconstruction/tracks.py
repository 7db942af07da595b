"""Multi-view feature tracks via connected components over verified pair
inliers: the port's copy of ``sfm_tpu/reconstruction/tracks.py``.

Every inlier match (img_i, kp_a) ~ (img_j, kp_b) of every accepted pair is
an edge in a graph over (image, keypoint) nodes; tracks are its connected
components. Tracks with two different keypoints in the same image are
inconsistent and dropped. The result is a padded (T, V) observation table
that the incremental engine reads with plain array indexing. The build is
vectorized (numpy edge extraction + scipy.sparse.csgraph connected
components). ``tests/test_torch_host_copies.py`` holds it against the
original.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TrackTable:
    """Padded track observations. T tracks, up to V views each.

    view_img[t, v] = image id (-1 past the end); view_kp = keypoint id in that
    image; view_xy = pixel coords. Tracks are sorted by length (longest
    first). ``kp_track[img, kp]`` inverts the mapping (-1 = no track).
    """

    view_img: np.ndarray   # (T, V) int32
    view_kp: np.ndarray    # (T, V) int32
    view_xy: np.ndarray    # (T, V, 2) float32
    length: np.ndarray     # (T,) int32
    kp_track: np.ndarray   # (N_images, K) int32 -> track id or -1

    @property
    def num_tracks(self) -> int:
        return self.view_img.shape[0]

    @property
    def max_views(self) -> int:
        return self.view_img.shape[1]

    def images_of(self, t: int):
        n = self.length[t]
        return self.view_img[t, :n]


def _empty_table(N: int, K: int, V: int) -> TrackTable:
    return TrackTable(
        view_img=np.full((0, V), -1, np.int32),
        view_kp=np.full((0, V), -1, np.int32),
        view_xy=np.zeros((0, V, 2), np.float32),
        length=np.zeros(0, np.int32),
        kp_track=np.full((N, K), -1, np.int32),
    )


def build_tracks(table, xy, num_images: int, max_views: int | None = None) -> TrackTable:
    """Build tracks from a PairTable + stacked keypoint coords.

    table: matching.PairTable; xy: (N, K, 2) keypoint pixel coords.
    Only *inlier* matches of *accepted* pairs contribute.
    """
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    xy = np.asarray(xy)
    N, K = xy.shape[:2]
    rows = table.accepted()
    if len(rows) == 0:
        return _empty_table(N, K, max_views or 2)

    # Edge list over flat (image, keypoint) node ids, one edge per inlier
    # match of every accepted pair — all pairs at once, no Python loop.
    # Work on the nonzero SUBSET from the start: materializing (R, M) int64
    # intermediates cost 50+ s at 512 cams / 104k pairs (round-3 verdict
    # next #3 — this host build bounded the global init); E-sized gathers
    # plus an O(N*K) presence-array compaction (no unique sort) run in
    # seconds at the same scale.
    inl = table.inliers[rows]                                    # (R, M) bool copy
    np.logical_and(inl, table.match_valid[rows], out=inl)
    r_idx, c_idx = np.nonzero(inl)                               # (E,)
    del inl
    if len(r_idx) == 0:
        return _empty_table(N, K, max_views or 2)
    rr = rows[r_idx]
    nk = N * K
    dt = np.int32 if nk < 2**31 else np.int64
    ea = table.pairs[rr, 0].astype(dt) * K + table.idx1[rr, c_idx]
    eb = table.pairs[rr, 1].astype(dt) * K + table.idx2[rr, c_idx]

    # Compact the touched nodes (presence scan over the small N*K id space)
    # and run union-find as sparse CC (C speed).
    present = np.zeros(nk, bool)
    present[ea] = True
    present[eb] = True
    nodes = np.nonzero(present)[0].astype(dt)
    n = len(nodes)
    remap = np.empty(nk, dt)
    remap[nodes] = np.arange(n, dtype=dt)
    g = sp.coo_matrix(
        (np.ones(len(ea), np.int8), (remap[ea], remap[eb])),
        shape=(n, n),
    )
    ncomp, label = connected_components(g, directed=False)

    imgs = nodes // K
    # Inconsistent components: two nodes sharing an image (after sorting by
    # (label, img), any adjacent duplicate image within a label flags it).
    order_li = np.lexsort((imgs, label))
    ls, is_ = label[order_li], imgs[order_li]
    dup = (ls[1:] == ls[:-1]) & (is_[1:] == is_[:-1])
    bad = np.zeros(ncomp, bool)
    bad[ls[1:][dup]] = True

    size = np.bincount(label, minlength=ncomp)
    keep_ids = np.nonzero((size >= 2) & ~bad)[0]
    if len(keep_ids) == 0:
        return _empty_table(N, K, max_views or 2)

    # Track order: longest first (stable for ties).
    track_order = keep_ids[np.argsort(-size[keep_ids], kind="stable")]
    T = len(track_order)
    track_of_comp = np.full(ncomp, -1, np.int64)
    track_of_comp[track_order] = np.arange(T)
    V = max_views or int(size[track_order[0]])

    # Observation slots: nodes sorted by (label, node id) — node id order
    # within a track = (image, keypoint) order, matching the engine's
    # expectations; slot v = position within the component, capped at V.
    order_ln = np.lexsort((nodes, label))
    ls2 = label[order_ln]
    starts = np.r_[0, np.nonzero(ls2[1:] != ls2[:-1])[0] + 1]
    counts = np.diff(np.r_[starts, n])
    pos = np.arange(n) - np.repeat(starts, counts)
    t_of = track_of_comp[ls2]
    sel = (t_of >= 0) & (pos < V)
    tt = t_of[sel]
    vv = pos[sel]
    nd = nodes[order_ln][sel]
    img, kp = (nd // K).astype(np.int64), (nd % K).astype(np.int64)

    view_img = np.full((T, V), -1, np.int32)
    view_kp = np.full((T, V), -1, np.int32)
    view_xy = np.zeros((T, V, 2), np.float32)
    view_img[tt, vv] = img
    view_kp[tt, vv] = kp
    view_xy[tt, vv] = xy[img, kp]
    length = np.minimum(size[track_order], V).astype(np.int32)
    kp_track = np.full((N, K), -1, np.int32)
    kp_track[img, kp] = tt
    return TrackTable(view_img, view_kp, view_xy, length, kp_track)
