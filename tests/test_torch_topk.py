"""Kernel K4's ``topk_rows``: its plain twin against ``jax.lax.top_k`` at each
caller's shape (small), and the wrapper's launch.

The twin (``estimators/ransac.py::top_k_plain``) is what the kernel is held
to on the card (values and indices identical), so it must be ``lax.top_k``
itself: largest first in IEEE total order (+0.0 above -0.0), ties to the
lower index, k = n a full sort. Inputs are made with numpy from a seed and
compared exactly (values bit for bit, indices equal).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_tpu_torch import _kernels
from sfm_tpu_torch.estimators import ransac as tran
from sfm_tpu_torch.matching import core as tcore


def _keypoint_selection(rng):
    # 12 images x the octaves' candidates -> the keypoint budget: scores on
    # a coarse grid (exact ties), -1 where a candidate is invalid.
    x = np.round(rng.random((12, 96)) * 20) / 20
    return np.where(rng.random((12, 96)) < 0.3, -1.0, x), 48


def _match_compaction(rng):
    # 32 pairs x 64 rows -> 32: -distance, -inf where the ratio or mutual
    # test failed (~60%), -0.0 where a descriptor repeats exactly.
    x = -np.round(rng.random((32, 64)) * 8) / 2
    x = np.where(rng.random((32, 64)) < 0.6, -np.inf, x)
    return np.where(rng.random((32, 64)) < 0.05, -0.0, x), 32


def _orb_merge(rng):
    # 12 x all rows, a full sort: FAST responses with exact ties across
    # levels, -inf where a row is padding.
    x = rng.integers(5, 40, (12, 80)).astype(np.float64)
    return np.where(rng.random((12, 80)) < 0.2, -np.inf, x), 80


def _ransac_sampling(rng):
    # (B iters) x N noise -> a sample of 8, a fifth of each row -inf.
    x = rng.random((256, 40))
    dead = np.argsort(rng.random((256, 40)), axis=1)[:, :8]
    np.put_along_axis(x, dead, -np.inf, axis=1)
    return x, 8


def _signed_zeros(rng):
    # -0.0 and +0.0 side by side (lax.top_k takes +0.0 as the larger), a
    # NaN above +inf.
    x = rng.choice(np.array([0.0, -0.0, 1.0, -1.0, np.inf, -np.inf]), (16, 24))
    x[3, 5] = np.nan
    return x, 24


def _all_equal(rng):
    return np.full((4, 33), 0.25), 20


CASES = {"keypoint_selection": _keypoint_selection, "match_compaction": _match_compaction,
         "orb_merge": _orb_merge, "ransac_sampling": _ransac_sampling,
         "ransac_sampling_k3": lambda rng: (_ransac_sampling(rng)[0], 3),
         "signed_zeros": _signed_zeros, "all_equal": _all_equal}


@pytest.mark.parametrize("case", sorted(CASES))
def test_top_k_plain_matches_lax_top_k(case):
    x, k = CASES[case](np.random.default_rng(13))
    x = x.astype(np.float32)
    v_j, i_j = jax.lax.top_k(jnp.asarray(x), k)
    v, i = tran.top_k_plain(torch.as_tensor(x), k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(v.numpy().view(np.int32), np.asarray(v_j).view(np.int32))
    # The CPU dispatcher is the twin.
    v2, i2 = tran.top_k(torch.as_tensor(x), k)
    assert torch.equal(i2, i) and torch.equal(v2.view(torch.int32), v.view(torch.int32))


def test_top_k_rows_launches_with_int64_indices(monkeypatch):
    calls = []
    monkeypatch.setattr(_kernels, "launch", lambda name, dev, *a: calls.append((name, a)))
    m = lambda *s: torch.empty(s, device="meta")
    x = m(12, 3840)
    v, i = tran.top_k_cuda(x, 2048)
    name, args = calls[-1]
    assert name == "topk_rows" and args[0] is x and args[1:4] == (12, 3840, 2048)
    assert args[4] is v and args[5] is i
    assert v.dtype == torch.float32 and i.dtype == torch.int64 and i.shape == (12, 2048)
    # Leading axes are rows; a contiguous input is passed as it is, another
    # one copied; k is capped at the row length.
    v, i = tran.top_k_cuda(m(4, 3, 50), 80)
    assert calls[-1][1][1:4] == (12, 50, 50) and i.shape == (4, 3, 50)
    y = m(50, 12).T
    tran.top_k_cuda(y, 8)
    assert calls[-1][1][0] is not y and calls[-1][1][0].is_contiguous()
    with pytest.raises(ValueError, match="exceeds"):
        tran.top_k_rows(m(2, 40000), 20000)


def test_match_compaction_takes_the_int64_order(monkeypatch):
    calls = []
    monkeypatch.setattr(_kernels, "launch", lambda name, dev, *a: calls.append((name, a)))
    m = lambda *s, **k: torch.empty(s, device="meta", **k)
    top, order = tran.top_k_cuda(m(32, 2048), 1024)
    out = tcore.match_compact_cuda(top, order, m(32, 2048, dtype=torch.int32), 1024)
    assert [c[0] for c in calls] == ["topk_rows", "match_compact"]
    assert calls[1][1][1] is order and out["idx1"].shape == (32, 1024)
    with pytest.raises(TypeError, match="dtype"):
        tcore.match_compact_cuda(top, order.int(), m(32, 2048, dtype=torch.int32), 1024)
