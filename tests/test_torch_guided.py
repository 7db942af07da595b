"""The port's guided 2D-3D rescue and BA table controls against ``sfm_tpu``.

Kernel K1-g's twin against ``_guided_match``; the engine's guided rescue on
``tests/test_reconstruction.py``'s multi-view scene with one image's pairs cut
(the port loses it without guided registration and recovers it with it, as
the JAX engine does); ``_model_pool`` and ``_extend_tracks`` on one shared
engine state; the BA observation table's compaction and ``max_obs`` cap; and
the new kernel wrappers' device routing. Inputs are numpy-seeded; tolerances
are stated per test.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_reconstruction import make_multiview
from torch_parity import n, t, unit_rows

from sfm_tpu.config import BAConfig, MatchConfig, PnPConfig, SfMConfig, VerifyConfig
from sfm_tpu.matching import all_pairs_sweep as j_sweep
from sfm_tpu.reconstruction import incremental as jinc
from sfm_tpu_torch.matching.pair_table import PairTable as TPairTable
from sfm_tpu_torch.reconstruction import incremental as tinc

VICTIM = 7


# ---------------------------------------------------------------- K1-g twin

def guided_inputs(rng, K=300, n_tracks=90, cap=200, D=32):
    """A pool of 2 near-duplicate entries per track plus padded slots, and
    keypoints that re-observe tracks, are random, or are invalid."""
    base = unit_rows(rng, (n_tracks, D))
    M = 2 * n_tracks
    pool = np.zeros((cap, D), np.float32)
    pool[:M] = np.repeat(base, 2, axis=0) + 0.02 * rng.standard_normal((M, D))
    pool[:M] /= np.linalg.norm(pool[:M], axis=-1, keepdims=True)
    pool_valid = np.arange(cap) < M
    pool_track = np.where(pool_valid, np.arange(cap) // 2, -1).astype(np.int32)
    desc = unit_rows(rng, (K, D))
    seen = rng.random(K) < 0.6
    src = rng.integers(0, n_tracks, K)
    d = base[src] + 0.1 * rng.standard_normal((K, D)).astype(np.float32)
    desc[seen] = (d / np.linalg.norm(d, axis=-1, keepdims=True))[seen]
    desc[5] = pool[0]                         # an exact tie between a track's entries
    pool[1] = pool[0]
    valid = rng.random(K) > 0.1
    return desc, valid, pool, pool_valid, pool_track


@pytest.mark.parametrize("ratio", [0.9, 0.75])
def test_guided_match_matches_jax(rng, ratio):
    # Tolerance: t_best and ok equal, d_best within 1e-6 (both f32 on the CPU).
    args = guided_inputs(rng)
    ref = [np.asarray(x) for x in jinc._guided_match(*map(jnp.asarray, args), ratio)]
    got = [n(x) for x in tinc.guided_match_plain(*map(t, args), ratio)]
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[2], ref[2])
    fin = np.isfinite(ref[1])
    np.testing.assert_array_equal(np.isfinite(got[1]), fin)
    np.testing.assert_allclose(got[1][fin], ref[1][fin], atol=1e-6)
    valid = args[1]
    assert (got[0][~valid] == args[4][0]).all()     # an all-inf row takes entry 0's track
    assert 0.3 * valid.sum() < got[2].sum() < valid.sum()
    wrapped = tinc.guided_match(*map(t, args), ratio)
    assert all(torch.equal(a, b) for a, b in zip(wrapped, tinc.guided_match_plain(
        *map(t, args), ratio)))


# ------------------------------------------------------------ guided rescue

@pytest.fixture(scope="module")
def scene():
    return make_multiview(np.random.default_rng(11))


@pytest.fixture(scope="module")
def cut_table(scene):
    """The scene's verified pairs with every pair of the victim rejected."""
    cfg = SfMConfig(matching=MatchConfig(max_matches=256), verify=VerifyConfig(ransac_iters=512))
    table = j_sweep(scene["xy"], scene["desc"], scene["valid"], cfg, chunk_size=8)
    keep = ~(table.pairs == VICTIM).any(1)
    return dataclasses.replace(table, accept=table.accept & keep)


RESCUE_CFG = SfMConfig(
    pnp=PnPConfig(ransac_iters=512, guided_iters=4096),
    ba=BAConfig(max_iterations=10, cg_iters=30, optimize_intrinsics=False),
    verify=VerifyConfig(rescue_disconnected=False),
)


def port_engine(scene, cut_table, cfg):
    fields = {f.name: getattr(cut_table, f.name) for f in dataclasses.fields(TPairTable)}
    table = TPairTable(**{k: np.array(v) for k, v in fields.items()})
    return tinc.StructureFromMotion(table, scene["xy"], cfg, device="cpu", desc=scene["desc"],
                                    feat_valid=scene["valid"])


def rotation_error_deg(res, scene, img):
    k = res.image_ids.tolist().index(img)
    k0 = 0 if res.image_ids[0] != img else 1
    rel_est = res.rotations[k] @ res.rotations[k0].T
    rel_gt = scene["R"][img] @ scene["R"][res.image_ids[k0]].T
    dR = rel_est @ rel_gt.T
    return np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))


@pytest.fixture(scope="module")
def blind(scene, cut_table):
    cfg = RESCUE_CFG.replace(pnp=dataclasses.replace(RESCUE_CFG.pnp, guided=False))
    sfm = port_engine(scene, cut_table, cfg)
    return sfm, sfm.run_reconstruction()


def test_port_without_guided_loses_the_victim(blind):
    _, res = blind
    assert VICTIM not in res.image_ids.tolist()
    assert len(res.image_ids) == 7


def test_port_guided_rescues_the_victim(scene, cut_table):
    # Tolerance: the reference test's gates (relative rotation within 2 deg
    # of ground truth, mean reprojection < 1 px).
    res = port_engine(scene, cut_table, RESCUE_CFG).run_reconstruction()
    assert VICTIM in res.image_ids.tolist()
    assert res.stats["mean_reprojection_error"] < 1.0
    assert rotation_error_deg(res, scene, VICTIM) < 2.0
    # The rescue extended the tracks that had room (most of this scene's
    # tracks already span all 7 other views, the table's capacity).
    assert (res.obs_img == VICTIM).sum() >= 1


def test_jax_guided_rescues_the_victim(scene, cut_table):
    res = jinc.StructureFromMotion(cut_table, scene["xy"], RESCUE_CFG, desc=scene["desc"],
                                   feat_valid=scene["valid"]).run_reconstruction()
    assert VICTIM in res.image_ids.tolist()
    assert rotation_error_deg(res, scene, VICTIM) < 2.0


def test_model_pool_and_extend_tracks_match_jax(scene, cut_table, blind):
    # The port's engine state after its blind run, copied into a JAX engine
    # on the same table: equal pools, and equal tracks after one extension.
    port, _ = blind
    ref = jinc.StructureFromMotion(cut_table, scene["xy"], RESCUE_CFG, desc=scene["desc"],
                                   feat_valid=scene["valid"])
    np.testing.assert_array_equal(ref.tracks.view_img, port.tracks.view_img)
    for k in ("rvec", "tvec", "registered", "points", "point_valid", "view_valid"):
        setattr(ref, k, np.array(getattr(port, k)))
    pd_t, pt_t = port._model_pool()
    pd_j, pt_j = ref._model_pool()
    np.testing.assert_array_equal(pt_t, pt_j)
    np.testing.assert_array_equal(pd_t, pd_j)
    assert len(pt_t) > 100 and pd_t.dtype == np.float32
    small = dataclasses.replace(RESCUE_CFG.pnp, guided_pool=64)
    for eng in (port, ref):
        eng.config = RESCUE_CFG.replace(pnp=small)
    np.testing.assert_array_equal(port._model_pool()[1], ref._model_pool()[1])
    assert len(port._model_pool()[1]) == 64

    # Every track of this scene spans all 7 other views (the table's
    # capacity): drop the last view of 50 tracks, in both tables, to make
    # room. Then extend tracks with and without room, with a repeated track
    # and a repeated keypoint.
    rng = np.random.default_rng(5)
    tr = port.tracks
    room = rng.permutation(tr.num_tracks)[:50]
    last = tr.length[room] - 1
    tr.kp_track[tr.view_img[room, last], tr.view_kp[room, last]] = -1
    tr.view_img[room, last] = -1
    tr.length[room] = last
    port.view_valid[room, last] = False
    for k in ("view_img", "view_kp", "view_xy", "length", "kp_track"):
        setattr(ref.tracks, k, np.array(getattr(tr, k)))
    ref.view_valid = np.array(port.view_valid)
    t_ids = np.concatenate([room[:40], rng.integers(0, tr.num_tracks, 20), room[:1]])
    kp_ids = rng.permutation(scene["xy"].shape[1])[:len(t_ids)]
    kp_ids[10] = kp_ids[11]
    n_t = port._extend_tracks(VICTIM, kp_ids, t_ids)
    n_j = ref._extend_tracks(VICTIM, kp_ids, t_ids)
    assert n_t == n_j >= 35
    for k in ("view_img", "view_kp", "view_xy", "length", "kp_track"):
        np.testing.assert_array_equal(getattr(port.tracks, k), getattr(ref.tracks, k), k)
    np.testing.assert_array_equal(port.view_valid, ref.view_valid)


def test_pick_diverse_two_matches_jax(rng):
    d = rng.standard_normal((50, 6, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ok = rng.random((50, 6)) > 0.4
    ok[0] = False
    ok[1, :] = False
    ok[1, 2] = True                                  # a single observation
    np.testing.assert_array_equal(tinc._pick_diverse_two(d, ok), jinc._pick_diverse_two(d, ok))


# ---------------------------------------------------- BA compaction and cap

class _TableState:
    """Just the state ``_ba_problem_arrays`` reads, for either package."""

    def __init__(self, view_img, view_xy, view_valid, registered, point_valid, max_obs):
        from sfm_tpu_torch.reconstruction.tracks import TrackTable

        T, V = view_img.shape
        self.tracks = TrackTable(view_img, np.zeros((T, V), np.int32), view_xy,
                                 (view_img >= 0).sum(1).astype(np.int32),
                                 np.zeros((1, 1), np.int32))
        self.view_valid = view_valid
        self.registered = registered
        self.point_valid = point_valid
        self.num_images = len(registered)
        self.config = SfMConfig(ba=BAConfig(max_obs=max_obs))


def big_table(rng, T, V, C=40, fill=0.5, first_two=False):
    """A host-only T x V track table with about ``fill`` of its slots valid."""
    view_img = rng.integers(0, C, (T, V)).astype(np.int32)
    empty = rng.random((T, V)) > fill
    if first_two:
        empty[:, :2] = False
    view_img[empty] = -1
    view_xy = rng.uniform(0, 1000, (T, V, 2)).astype(np.float32)
    view_valid = (view_img >= 0) & (rng.random((T, V)) > 0.05)
    if first_two:
        view_valid[:, :2] = True
    registered = (rng.random(C) > 0.1) | first_two
    point_valid = rng.random(T) > 0.1
    return view_img, view_xy, view_valid, registered, point_valid


def ba_arrays(mod, state):
    return [np.asarray(a) for a in mod.StructureFromMotion._ba_problem_arrays(state)]


def test_compaction_matches_jax_on_the_valid_rows(rng):
    # 1.3M slots, ~45% valid: both compact; the port keeps exactly the
    # reference's valid rows (the reference pads them to a 262,144 bucket).
    arrays = big_table(rng, T=32_500, V=40, fill=0.5)
    state = _TableState(*arrays, max_obs=0)
    cam_t, pt_t, xy_t, ok_t = ba_arrays(tinc, state)
    cam_j, pt_j, xy_j, ok_j = ba_arrays(jinc, state)
    assert ok_t.all() and len(ok_t) == ok_j.sum() < 0.6 * 32_500 * 40
    np.testing.assert_array_equal(cam_t, cam_j[ok_j])
    np.testing.assert_array_equal(pt_t, pt_j[ok_j])
    np.testing.assert_array_equal(xy_t, xy_j[ok_j])
    assert (np.diff(pt_t.astype(np.int64) * 40) >= 0).all()


def test_small_table_is_not_compacted(rng):
    state = _TableState(*big_table(rng, T=500, V=12), max_obs=0)
    for a, b in zip(ba_arrays(tinc, state), ba_arrays(jinc, state)):
        np.testing.assert_array_equal(a, b)
    assert len(ba_arrays(tinc, state)[0]) == 500 * 12


def test_cap_equals_jax_when_the_first_two_slots_are_valid(rng):
    arrays = big_table(rng, T=3000, V=16, fill=0.6, first_two=True)
    state = _TableState(*arrays, max_obs=9000)
    got, ref = ba_arrays(tinc, state), ba_arrays(jinc, state)
    k = ref[3].sum()
    assert 6000 <= k <= 9000
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b[:k])


def test_cap_keeps_the_first_two_valid_observations(rng):
    # Slots 0-1 often invalid: the reference protects slots < 2 and drops
    # some tracks' first valid views; the port keeps two valid views of every
    # track that has them.
    view_img, view_xy, view_valid, registered, point_valid = big_table(rng, T=3000, V=16,
                                                                       fill=0.6)
    registered[:] = True
    state = _TableState(view_img, view_xy, view_valid, registered, point_valid, max_obs=7000)
    V = 16
    obs_ok = (view_valid & point_valid[:, None]).reshape(-1)
    sel = np.nonzero(obs_ok)[0]
    t_of = sel // V
    first_two = np.concatenate([s[:2] for s in np.split(sel, np.nonzero(np.diff(t_of))[0] + 1)])

    def kept_slots(mod):
        cam, pt, xy, ok = ba_arrays(mod, state)
        key = {(int(p), tuple(x)) for p, x in zip(pt[ok], xy[ok])}
        return np.array([(int(s // V), tuple(view_xy.reshape(-1, 2)[s])) in key
                         for s in first_two])

    assert kept_slots(tinc).all()
    assert not kept_slots(jinc).all()
    assert len(ba_arrays(tinc, state)[0]) <= 7000


# ------------------------------------------------------------- wrappers

def test_new_wrappers_route_by_device(rng):
    from sfm_tpu_torch.features import pyramid as tpyr
    from sfm_tpu_torch.matching import retrieval as tret
    from sfm_tpu_torch.reconstruction import seed as tseed

    m = lambda *s, **k: torch.empty(s, device="meta", **k)
    with pytest.raises(ValueError, match="device"):
        tpyr.build_pyramid(m(1, 32, 32), num_octaves=2)
    with pytest.raises(ValueError, match="device"):
        tseed._score_pairs(m(2, 3, 3), m(2, 8, 2), m(2, 8, 2), m(2, 8, dtype=torch.bool),
                           m(3, 3))
    with pytest.raises(ValueError, match="device"):
        tinc.guided_match(m(4, 32), m(4, dtype=torch.bool), m(6, 32),
                          m(6, dtype=torch.bool), m(6, dtype=torch.int32), 0.9)
    with pytest.raises(ValueError, match="device"):
        tret.score_chunk(m(2, 2, dtype=torch.int32), m(3, 8, 32), m(3, 8, dtype=torch.bool),
                         0.75)
    # On a CPU tensor each wrapper is its twin.
    img = torch.as_tensor(rng.random((2, 40, 48), dtype=np.float32))
    for a, b in zip(tpyr.build_pyramid(img, num_octaves=2, upsample=True),
                    tpyr.build_pyramid_plain(img, num_octaves=2, upsample=True)):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    P, N = 3, 40
    F = torch.as_tensor(rng.standard_normal((P, 3, 3)), dtype=torch.float32)
    xy = torch.as_tensor(rng.uniform(0, 500, (2, P, N, 2)), dtype=torch.float32)
    valid = torch.as_tensor(rng.random((P, N)) > 0.2)
    K = torch.tensor([[500.0, 0, 250], [0, 500, 250], [0, 0, 1]])
    for a, b in zip(tseed._score_pairs(F, xy[0], xy[1], valid, K),
                    tseed._score_pairs_plain(F, xy[0], xy[1], valid, K)):
        assert torch.equal(a, b)


def test_kernel_wrappers_refuse_shapes_the_kernels_do_not_take():
    from sfm_tpu_torch.features import pyramid as tpyr
    from sfm_tpu_torch.matching import retrieval as tret
    from sfm_tpu_torch.reconstruction import seed as tseed

    m = lambda *s, **k: torch.empty(s, device="meta", **k)
    with pytest.raises(ValueError, match="radius"):
        tpyr.build_pyramid_cuda(m(1, 32, 32), num_octaves=2, sigma0=4.0)
    with pytest.raises(ValueError, match="S="):
        tret.score_chunk_cuda(m(2, 2, dtype=torch.int32), m(3, 2048, 32),
                              m(3, 2048, dtype=torch.bool), 0.75)
    with pytest.raises(ValueError, match="matches exceed"):
        tseed._score_pairs_cuda(m(2, 3, 3), m(2, 2000, 2), m(2, 2000, 2),
                                m(2, 2000, dtype=torch.bool), m(3, 3))
    with pytest.raises(ValueError, match="multiple"):
        tinc.guided_match_cuda(m(4, 20), m(4, dtype=torch.bool), m(6, 20),
                               m(6, dtype=torch.bool), m(6, dtype=torch.int32), 0.9)
