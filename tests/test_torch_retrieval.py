"""The port's candidate-pair retrieval against ``sfm_tpu.matching.retrieval``.

Kernel K1-r's twin (``score_chunk_plain``) against ``_score_chunk`` on random
unit descriptors with invalid rows and columns and duplicated descriptors
(exact distance ties), and ``select_candidate_pairs`` of both packages on one
synthetic scene: fixed, adaptive and sequential selection keep the same
pairs. Inputs are numpy-seeded. Both sides compute in float32 on the CPU, so
the counts and the kept pairs must be equal.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import n, t, unit_rows

from sfm_tpu.config import RetrievalConfig
from sfm_tpu.matching import retrieval as jret
from sfm_tpu_torch.matching import retrieval as tret


def tied_descriptors(rng, N=6, S=48, D=32):
    """Unit descriptors where image 3 re-observes image 0 under noise, and
    some descriptors are exact copies of others in the same image (ties in
    both the row and the column direction)."""
    desc = unit_rows(rng, (N, S, D))
    desc[3] = desc[0] + 0.05 * rng.standard_normal((S, D)).astype(np.float32)
    desc[3] /= np.linalg.norm(desc[3], axis=-1, keepdims=True)
    desc[4, :20] = desc[1, :20]
    for img, src, dst in ((0, 3, 10), (0, 7, 40), (3, 5, 6), (1, 2, 30), (4, 1, 25)):
        desc[img, dst] = desc[img, src]
    valid = rng.random((N, S)) > 0.1
    valid[5, :] = False                     # an image with no valid keypoint
    return desc, valid


@pytest.mark.parametrize("ratio", [0.75, 0.9])
def test_score_chunk_matches_jax(rng, ratio):
    desc, valid = tied_descriptors(rng)
    i, j = np.triu_indices(desc.shape[0], k=1)
    pairs = np.concatenate([np.stack([i, j], -1), [[0, 0], [3, 3]]]).astype(np.int32)
    ref = jret._score_chunk(jnp.asarray(pairs), jnp.asarray(desc), jnp.asarray(valid), ratio)
    got = tret.score_chunk_plain(t(pairs), t(desc), t(valid), ratio)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(n(got), n(ref))
    assert n(got).max() >= 10 and n(got)[pairs[:, 0] == 5].sum() == 0
    # On a CPU tensor the wrapper is the twin.
    np.testing.assert_array_equal(n(tret.score_chunk(t(pairs), t(desc), t(valid), ratio)),
                                  n(got))


def corridor_descriptors(rng, N=14, S=64, D=32, n_points=240):
    """Image k sees a window of a long strip of points (noisy descriptor
    copies, in a shuffled order): neighbours share many, far images none."""
    pts = unit_rows(rng, (n_points, D))
    desc = np.zeros((N, S, D), np.float32)
    for k in range(N):
        ids = rng.permutation(np.arange(12 * k, 12 * k + S) % n_points)
        d = pts[ids] + 0.08 * rng.standard_normal((S, D)).astype(np.float32)
        desc[k] = d / np.linalg.norm(d, axis=-1, keepdims=True)
    valid = rng.random((N, S)) > 0.05
    return desc, valid


@pytest.mark.parametrize("cfg", [
    RetrievalConfig(subsample=48, min_score=8, top_k=2, adaptive=False, chunk_size=16),
    RetrievalConfig(subsample=48, min_score=12, top_k=1, adaptive=True, chunk_size=16),
    RetrievalConfig(subsample=64, min_score=30, top_k=0, adaptive=False, chunk_size=1024),
    RetrievalConfig(mode="sequential", sequential_window=3),
], ids=["fixed", "adaptive", "no-floor", "sequential"])
def test_select_candidate_pairs_keeps_jax_pairs(rng, cfg):
    desc, valid = corridor_descriptors(rng)
    N = desc.shape[0]
    kept_j, st_j = jret.select_candidate_pairs(desc, valid, N, cfg)
    kept_t, st_t = tret.select_candidate_pairs(desc, valid, N, cfg)
    np.testing.assert_array_equal(kept_t, np.asarray(kept_j))
    for k in ("candidates", "kept", "keep_frac"):
        assert st_t[k] == st_j[k], k
    if cfg.mode != "sequential":
        assert st_t["threshold_median"] == st_j["threshold_median"]
        assert 0 < st_t["kept"] < st_t["candidates"]


def test_retrieval_scores_and_rules_match_jax(rng):
    desc, valid = corridor_descriptors(rng)
    N = desc.shape[0]
    cfg = RetrievalConfig(subsample=40, chunk_size=7)
    pairs = np.stack(np.triu_indices(N, k=1), -1).astype(np.int32)
    scores = tret.retrieval_scores(t(desc), valid, pairs, cfg)
    assert scores.dtype == np.int32
    np.testing.assert_array_equal(scores, jret.retrieval_scores(desc, valid, pairs, cfg))
    for top_k in (0, 1, 3):
        np.testing.assert_array_equal(
            tret.select_pairs_from_scores(scores, pairs, N, 9, top_k),
            jret.select_pairs_from_scores(scores, pairs, N, 9, top_k))
    adaptive = dataclasses.replace(cfg, top_k=2, min_score=20, adaptive_beta=0.6)
    keep_t, thr_t = tret.select_pairs_adaptive(scores, pairs, N, adaptive)
    keep_j, thr_j = jret.select_pairs_adaptive(scores, pairs, N, adaptive)
    np.testing.assert_array_equal(keep_t, keep_j)
    assert thr_t == thr_j
