"""Kernels of one checkout against another's, bit for bit, on the card: K11's
matvec and PCG, K10's coupling, K7's triangulation, K8+K9's linearization
and K1's top-2.

    python tests/bits_report.py dump --scene D --pipeline P [--orb G] --out DIR
    python tests/bits_report.py run --repo REPO
                                    [--cases matvec,coupling,triangulate,linearize,match]
                                    [--inputs DIR] [--vectors 8] --out FILE.pt
    python tests/bits_report.py compare A.pt B.pt

``dump`` runs this checkout's ``reconstruct`` on path d's artifacts (``P``,
the 150-view ``pipeline`` output of ``chip_smoke.py``, on its scene ``D``)
and writes to ``DIR`` the inputs of the largest dense BA call's S (the
linearized system, its damping and grouping), the engine's whole track
table with its final poses (``_triangulate``'s inputs for every row) and
the inputs of its largest ``run_ba`` call (the problem and its config);
then the first 32-pair chunk of ``P``'s sweep (its descriptors as the pair
table stores them, float16) and, with ``--orb`` (path g's ``pipeline``
output), the first chunk of its D = 256 sweep.

``run`` imports ``sfm_tpu_torch`` and ``chip_smoke`` from the checkout
``REPO`` (so each checkout runs its own kernels, built from its own sources)
and saves, for each case, its outputs, a digest of its inputs and its times:

- ``matvec``: ``schur_matvec_cuda`` at ``--vectors`` random x and a 50-step
  PCG solve (``pcg_solve_cuda``, tol 0) on the smoke's 300-camera /
  600k-observation scene on every route (``pcg_system``, ``island_system``),
  the same systems in point-major order (the engine's layout) and the
  5,000-camera scene (``BIG_BA_SCENE``); the matvec's wrapper and device time
  and the solve's time.
- ``coupling``: ``schur_matrix_cuda``'s S on ``phase_ba``'s scene, on
  ``phase_island``'s on each island route and (with ``--inputs``) on the
  dumped system; wrapper, device and the coupling kernels' own device time.
- ``linearize``: ``linearize_cuda``'s ten outputs (Jc, Jk, Jp, rw, V, g_p,
  U, g_c, Uk, g_k) and ``total_huber_cost_cuda``'s cost on ``phase_ba``'s
  scene, on ``phase_island``'s on each island route, on the same scenes
  with rotations of ~0.4 rad (every route) and (with
  ``--inputs``) on the first linearization of the dumped ``run_ba`` call,
  its arguments built as ``run_ba`` builds them; the linearization's and the
  cost's wrapper, device and kernel times (the workspace made once where
  the wrapper takes one, as ``run_ba`` makes it).
- ``match``: ``match_top2_cuda``'s idx, best, second and back (mutual) on
  ``phase_match_top2``'s chunk and tie-heavy input, ``phase_match_binary``'s
  D = 256 chunk, ragged shapes (K1 != K2, neither a multiple of 128; D = 96
  and 384) and (with ``--inputs``) the dumped chunks of paths d and g.
- ``triangulate``: ``triangulate_tracks_cuda``'s points and flags on
  ``phase_triangulate``'s two buckets and (with ``--inputs``) on the dumped
  table: its first 2,048 to 16,384 rows, all of it and the table tiled to
  path h's 41,090 rows with seed pairs off, then its first 1,024 failures
  with seed pairs on. Where the checkout's wrapper takes a ``layout``, each
  of these also runs a warp a row and a thread a row, held against the
  other checkout's own choice.

Wrapper times are the median of five means of 10 calls (the workspaces and
K7's camera tensors made once where the wrapper takes them, as ``run_ba``
and the engine make them), device times one ``torch.profiler`` trace.
``compare`` prints, for each case, whether the two checkouts' inputs and
outputs are identical, and both checkouts' times, then one JSON line. Two
processes, since both checkouts' packages share a name. Needs a card.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import importlib.util
import inspect
import json
import pickle
import shutil
import sys
from pathlib import Path

CASES = ("matvec", "coupling", "triangulate", "linearize", "match")
# The BAProblem fields the dump keeps of the largest run_ba call.
BA_FIELDS = ("rvec", "tvec", "cam_valid", "cam_fixed", "intr", "points", "point_valid",
             "obs_cam", "obs_point", "obs_xy", "obs_valid", "intr_c")
# Path d's table sliced to these rows (then all of it, then tiled to path h's
# whole-table launch): K7's two layouts across the engine's launch sizes.
TABLE_ROWS = (2048, 4096, 8192, 12288, 16384)
PATH_H_TABLE_ROWS = 41090


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        if t is not None:
            h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def dump(args) -> int:
    """The largest dense BA call's system and the final track table of this
    checkout's reconstruct on path d's artifacts."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import numpy as np
    import torch

    from sfm_tpu_torch import cli
    from sfm_tpu_torch.ba import schur as S
    from sfm_tpu_torch.reconstruction import incremental as inc

    out = Path(args.out)
    run_dir = out / "reconstruct"
    run_dir.mkdir(parents=True, exist_ok=True)
    shutil.copy(Path(args.pipeline) / "pair_table.pkl", run_dir / "pair_table.pkl")
    seen = {"ba": None, "engine": None, "run_ba": None}
    real_s, real_t, real_run = S.schur_matrix_cuda, inc.StructureFromMotion._triangulate, inc.run_ba

    def schur_matrix_cuda(lin, op, perm, perm_valid, *a, **kw):
        if seen["ba"] is None or lin.U.shape[0] >= seen["ba"][0].U.shape[0]:
            cpu = lambda nt: nt._replace(**{f: getattr(nt, f).cpu() for f in nt._fields
                                            if isinstance(getattr(nt, f), torch.Tensor)})
            seen["ba"] = (cpu(lin), cpu(op), perm.cpu(), perm_valid.cpu())
        return real_s(lin, op, perm, perm_valid, *a, **kw)

    def _triangulate(self, *a, **kw):
        seen["engine"] = self
        return real_t(self, *a, **kw)

    def run_ba(problem, config, *a, **kw):
        last = seen["run_ba"]
        if last is None or problem.obs_cam.shape[0] >= last[0]["obs_cam"].shape[0]:
            cpu = lambda f: None if getattr(problem, f) is None else getattr(problem, f).cpu()
            seen["run_ba"] = ({f: cpu(f) for f in BA_FIELDS}, dataclasses.asdict(config), a, kw)
        return real_run(problem, config, *a, **kw)

    S.schur_matrix_cuda, inc.StructureFromMotion._triangulate = schur_matrix_cuda, _triangulate
    inc.run_ba = run_ba
    rc = cli.main(["--log_level", "WARNING", "reconstruct", "--data_dir", str(args.scene),
                   "--output_dir", str(run_dir), "--device", "cuda", "--no_mask"])
    if rc != 0 or seen["ba"] is None or seen["engine"] is None:
        raise SystemExit(f"bits_report dump: reconstruct rc {rc}, no dense BA call or no "
                         "triangulation")
    lin, op, perm, pvm = seen["ba"]
    torch.save({"lin": lin._asdict(), "op": op._asdict(), "perm": perm, "perm_valid": pvm},
               out / "ba.pt")
    eng = seen["engine"]
    cfg = eng.config.triangulation
    img = eng.tracks.view_img
    use = eng.view_valid & eng.registered[np.clip(img, 0, eng.num_images - 1)]
    torch.save({"view_img": img, "view_xy": eng.tracks.view_xy, "use": use, "rvec": eng.rvec,
                "tvec": eng.tvec, "K": eng._camera_matrix(),
                "common": dict(max_err=cfg.max_reproj_error, min_parallax_deg=cfg.min_parallax_deg,
                               robust_rounds=cfg.robust_rounds, n_seed=cfg.seed_pair_views)},
               out / "tracks.pt")
    prob, config, a, kw = seen["run_ba"]
    torch.save({"problem": prob, "config": config, "args": a, "kwargs": kw}, out / "run_ba.pt")
    chunks = [("match_d", Path(args.pipeline))] + ([("match_g", Path(args.orb))]
                                                   if args.orb else [])
    for name, where in chunks:
        blob = pickle.loads((where / "pair_table.pkl").read_bytes())
        ij = blob["table"].pairs[:32]
        desc, valid = blob["desc"], blob["valid"]
        f32 = lambda x: torch.as_tensor(np.ascontiguousarray(x, np.float32))
        torch.save({"d1": f32(desc[ij[:, 0]]), "v1": torch.as_tensor(valid[ij[:, 0]]),
                    "d2": f32(desc[ij[:, 1]]), "v2": torch.as_tensor(valid[ij[:, 1]])},
                   out / f"{name}.pt")
        print(f"dumped: {name}, the first {len(ij)} pairs of {where} ({desc.shape[1]} x "
              f"{desc.shape[2]} descriptors)", flush=True)
    print(f"dumped: S of a {lin.U.shape[0]}-camera BA call ({lin.Jc.shape[0]} observations), "
          f"{img.shape[0]} track rows x {img.shape[1]} slots, {int(eng.registered.sum())} "
          f"registered cameras; the largest run_ba call: {prob['rvec'].shape[0]} cameras, "
          f"{prob['obs_cam'].shape[0]} observations", flush=True)
    return 0


def _point_major():
    """``chip_smoke.point_major`` of this checkout (the other checkout's
    ``chip_smoke`` may predate it): it takes the package's ``schur`` module
    as an argument, so it runs on either checkout's kernels."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.point_major


class Runner:
    """One checkout's kernels (``torch``, its ``chip_smoke`` as ``cs``, its
    ``schur`` and ``incremental`` modules) and the cases they wrote."""

    def __init__(self, torch, cs, S, inc):
        self.torch, self.cs, self.S, self.inc = torch, cs, S, inc
        self.cases = {}
        self.failures = torch.zeros(0, dtype=torch.int64)  # K7's first failures on path d

    def kernel_ms(self, fn, names, reps=10):
        """The device time a call of the kernels whose names hold one of
        ``names`` (one torch.profiler trace; the wrapper's other kernels left
        out)."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        self.torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            self.torch.cuda.synchronize()
        us = sum(e.device_time_total for e in prof.key_averages()
                 if any(k in e.key for k in names))
        return us / 1e3 / reps if us > 0 else None

    def add(self, name, digest_in, outs, shape, times, ref=None, names=None):
        """Records a case; ``ref`` names the other checkout's case that its
        outputs are held against (by default its own name); ``names``: the
        outputs' names, for the report of which ones differ."""
        self.cases[name] = {"digest_in": digest_in, "out": [o.cpu() for o in outs],
                            "shape": shape, "times": times, "ref": ref or name,
                            "names": names}
        shown = ", ".join(f"{k} {self.cs.fmt_ms(v)}" for k, v in times.items())
        print(f"{name}: {shape}; {shown}", flush=True)

    def timed(self, fn, names):
        cs, torch = self.cs, self.torch
        return {"wrapper_ms": cs.median_ms(torch, fn), "device_ms": cs.device_ms(torch, fn),
                "kernel_ms": self.kernel_ms(fn, names)}


def run_matvec(r: Runner, args):
    torch, cs, S = r.torch, r.cs, r.S
    import numpy as np

    point_major = _point_major()
    dev = torch.device("cuda")
    takes_work = "work" in inspect.signature(S.schur_matvec_cuda).parameters
    routes = {"": (6, torch.float32), **{k: (B, getattr(torch, d))
                                          for k, (B, d) in cs.ISLAND_ROUTES.items()}}
    for scene in ("c300", "c300_point_major", "c5000"):
        for route, (B, dt) in routes.items():
            if scene == "c5000":
                a, kw = cs.island_system(torch, np, dev, B, dt, *cs.BIG_BA_SCENE, 500,
                                         cs.BIG_BA_PINNED)
            elif route:
                a, kw = cs.island_system(torch, np, dev, B, dt, cs.K11_CAMS, cs.K11_POINTS,
                                         cs.K11_OBS_PER_CAM, 300, cs.K11_PINNED)
            else:
                lin0, perm, pvm = cs.pcg_system(torch, np, dev, cs.K11_CAMS, cs.K11_POINTS,
                                                cs.K11_OBS_PER_CAM, 300, cs.K11_PINNED)
            if scene == "c5000" or route:
                lin0 = S.linearize_cuda(*a, **kw)
                perm, pvm = a[10], a[11]
            lin = lin0
            if scene == "c300_point_major":
                lin, perm, pvm = point_major(torch, S, lin0, perm, pvm)
            op, rhs_c, rhs_k = S.damp_operator(lin, 1e-3, perm, pvm, precond=True)
            C = lin.U.shape[0]
            g = torch.Generator(device=dev).manual_seed(9)
            extra = {"work": S.matvec_workspace(lin, perm, pvm)} if takes_work else {}
            sx = []
            for _ in range(args.vectors):
                xc = (1e-2 * torch.randn((C, B), device=dev, generator=g)).to(dt)
                xk = (1e-1 * torch.randn(4, device=dev, generator=g)).to(dt)
                sx.append(torch.cat([t.reshape(-1) for t in S.schur_matvec_cuda(
                    lin, op, xc, xk, perm, pvm, **extra)]))
            pcg = lambda: S.pcg_solve_cuda(lin, op, rhs_c, rhs_k, perm, pvm, 50, 0.0, **extra)
            xc_, xk_, steps = pcg()
            mv = lambda: S.schur_matvec_cuda(lin, op, xc, xk, perm, pvm, **extra)
            r.add(f"matvec/{scene}/{route or 'default'}",
                  _digest(lin.Jc, lin.Jk, lin.Jp, lin.obs_cam, lin.obs_point, op.Vinv,
                          op.lam_diag_c, op.lam_diag_k, perm, pvm),
                  [torch.stack(sx), torch.cat([xc_.reshape(-1), xk_]),
                   torch.tensor([int(steps)])],
                  f"C={C}, {int(pvm.sum())} valid observations, S x at {args.vectors} vectors "
                  "and a 50-step PCG",
                  {"wrapper_ms": cs.median_ms(torch, mv), "device_ms": cs.device_ms(torch, mv),
                   "pcg50_ms": cs.median_ms(torch, pcg, batches=3, reps=3)})
            del lin, lin0, op, extra
            torch.cuda.empty_cache()


def run_coupling(r: Runner, args):
    torch, cs, S = r.torch, r.cs, r.S
    import numpy as np

    dev = torch.device("cuda")
    takes_work = "work" in inspect.signature(S.schur_matrix_cuda).parameters
    lam = 1e-3

    def coupling(name, lin, op, perm, pvm):
        extra = {"work": S.coupling_workspace(lin, perm, pvm)} if takes_work else {}
        fn = lambda: S.schur_matrix_cuda(lin, op, perm, pvm, **extra)
        Sm = fn()
        torch.cuda.synchronize()
        r.add(name, _digest(lin.Jc, lin.Jk, lin.Jp, lin.obs_cam, lin.obs_point, lin.U, lin.Uk,
                            op.Vinv, op.lam_diag_c, op.lam_diag_k, perm, pvm),
              [Sm], f"C={lin.U.shape[0]}, B={lin.U.shape[-1]}, {lin.U.dtype}, "
                    f"{int(pvm.sum())} valid observations",
              r.timed(fn, ("coupling", "schur_finish", "row_scale")))

    # phase_ba's scene (the default route), phase_island's on each island route.
    rvec, tvec, intr, pts, obs_cam, obs_point, obs_xy = cs.ba_scene(torch, np, dev)
    C, P, O = rvec.shape[0], pts.shape[0], obs_cam.shape[0]
    perm, pvm = S.coobs_pairs(obs_point.cpu().numpy(), np.ones(O, bool))
    perm, pvm = torch.as_tensor(perm, device=dev), torch.as_tensor(pvm, device=dev)
    cam_free = torch.ones(C, device=dev)
    cam_free[0] = 0.0
    lin = S.linearize_cuda(rvec, tvec, intr, pts, obs_cam, obs_point, obs_xy,
                           torch.ones(O, device=dev), cam_free,
                           torch.ones(P, dtype=torch.bool, device=dev), perm, pvm, 2.0, True,
                           torch.eye(4, device=dev), torch.zeros(4, device=dev))
    op, _, _ = S.damp_operator(lin, lam, perm, pvm)
    coupling("phase_ba/default", lin, op, perm, pvm)
    for route, (B, dname) in cs.ISLAND_ROUTES.items():
        a, kw = cs.island_system(torch, np, dev, B, getattr(torch, dname), *cs.ISLAND_SCENE, 0)
        lin = S.linearize_cuda(*a, **kw)
        op, _, _ = S.damp_operator(lin, lam, a[10], a[11])
        coupling(f"phase_island/{route}", lin, op, a[10], a[11])
        torch.cuda.empty_cache()
    if args.inputs:
        ba = torch.load(Path(args.inputs) / "ba.pt", weights_only=False)
        to = lambda d: {k: None if v is None else v.to(dev) for k, v in d.items()}
        coupling("path_d/largest_dense_ba", S.Linearization(**to(ba["lin"])),
                 S.Damped(**to(ba["op"])), ba["perm"].to(dev), ba["perm_valid"].to(dev))


def run_triangulate(r: Runner, args):
    torch, cs, inc = r.torch, r.cs, r.inc
    import numpy as np

    dev = torch.device("cuda")
    params = inspect.signature(inc.triangulate_tracks_cuda).parameters
    takes_cams, takes_layout = "cams" in params, "layout" in params

    def triangulate(name, view_img, view_xy, use, rvec, tvec, K, common, seed_on):
        T = view_img.shape[0]
        active = torch.ones(T, dtype=torch.bool, device=dev)
        # The camera tensors once where the wrapper takes them, as the engine
        # makes them for a pass's buckets.
        extra = {"cams": inc.triangulate_cameras(rvec, tvec, K)} if takes_cams else {}
        layouts = {"": {}}
        if takes_layout:
            layouts.update({"/warp_a_row": {"layout": 0}, "/thread_a_row": {"layout": 1}})
        ok = None
        for tag, kw in layouts.items():
            fn = lambda: inc.triangulate_tracks_cuda(
                view_img, view_xy, use, active, rvec, tvec, K, common["max_err"],
                common["min_parallax_deg"], common["robust_rounds"], seed_on, common["n_seed"],
                **extra, **kw)
            pts, ok_t = fn()
            torch.cuda.synchronize()
            ok = ok_t if ok is None else ok
            r.add(name + tag, _digest(view_img, view_xy, use, active, rvec, tvec, K),
                  [pts, ok_t], f"T={T}, V={view_img.shape[1]}, seed pairs {seed_on}, "
                               f"{int(ok_t.sum())} ok",
                  r.timed(fn, ("triangulate",)), ref=name)
        return ok

    smoke = dict(max_err=4.0, min_parallax_deg=0.0, robust_rounds=1, n_seed=8)
    for T, seed_on in ((2048, False), (1024, True)):
        view_img, view_xy, registered, rvec, tvec, K = cs.track_scene(torch, np, dev, T, seed=T)
        use = (view_img >= 0) & registered[view_img.long().clamp(min=0)]
        triangulate(f"phase_triangulate/T{T}_seed_pairs_{seed_on}", view_img, view_xy, use,
                    rvec, tvec, K, smoke, seed_on)
    if not args.inputs:
        return
    tr = torch.load(Path(args.inputs) / "tracks.pt", weights_only=False)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    table = (torch.as_tensor(tr["view_img"], device=dev), f32(tr["view_xy"]),
             torch.as_tensor(tr["use"], device=dev))
    poses = (f32(tr["rvec"]), f32(tr["tvec"]), f32(tr["K"]))
    n = table[0].shape[0]
    for T in TABLE_ROWS:
        if T < n:
            triangulate(f"path_d/first_{T}_rows_seed_pairs_off",
                        *(x[:T].contiguous() for x in table), *poses, tr["common"], False)
    ok = triangulate("path_d/all_rows_seed_pairs_off", *table, *poses, tr["common"], False)
    tiled = [x.repeat((-(-PATH_H_TABLE_ROWS // n),) + (1,) * (x.dim() - 1))[:PATH_H_TABLE_ROWS]
             .contiguous() for x in table]
    triangulate(f"path_d/tiled_to_{PATH_H_TABLE_ROWS}_rows_seed_pairs_off", *tiled, *poses,
                tr["common"], False)
    fail = torch.nonzero(~ok).flatten()[:1024]
    r.failures = fail.cpu()
    triangulate("path_d/first_1024_failures_seed_pairs_on",
                *(x[fail].contiguous() for x in table), *poses, tr["common"], True)


LIN_KERNELS = ("ba_obs", "ba_shift", "ba_sum", "ba_finish", "ba_point", "lin_row", "lin_sum")
LIN_OUTPUTS = ("Jc", "Jk", "Jp", "rw", "V", "g_p", "U", "g_c", "Uk", "g_k")


def run_ba_args(torch, np, S, lm, prob, config, optimize_intrinsics, dev):
    """The arguments of the first linearization of ``run_ba(prob, config)`` on
    the default route (shared intrinsics, float32), as ``run_ba`` builds them."""
    if config["per_camera_intrinsics"] or config["f64_normal_equations"]:
        raise SystemExit("bits_report: the dumped run_ba call is not on the default route")
    p = {k: None if v is None else v.to(dev) for k, v in prob.items()}
    perm, pvm = S.coobs_pairs(p["obs_point"].cpu().numpy(), p["obs_valid"].cpu().numpy())
    perm, pvm = torch.as_tensor(perm, device=dev), torch.as_tensor(pvm, device=dev)
    cam_free = (p["cam_valid"] & ~p["cam_fixed"]).to(torch.float32)
    obs_w = (p["obs_valid"] & p["cam_valid"][p["obs_cam"].long()]
             & p["point_valid"][p["obs_point"].long()]).to(torch.float32)
    if optimize_intrinsics:
        _, Hreg, greg = lm._intr_reg(p["intr"], p["intr"],
                                     float(np.float32(config["intrinsics_reg_weight"])))
    else:
        Hreg = torch.eye(4, dtype=torch.float32, device=dev)
        greg = torch.zeros(4, dtype=torch.float32, device=dev)
    return (p["rvec"], p["tvec"], p["intr"], p["points"], p["obs_cam"], p["obs_point"],
            p["obs_xy"], obs_w, cam_free, p["point_valid"], perm, pvm, config["huber_delta"],
            optimize_intrinsics, Hreg, greg)


def run_linearize(r: Runner, args):
    torch, cs, S = r.torch, r.cs, r.S
    import numpy as np

    from sfm_tpu_torch.ba import lm
    from sfm_tpu_torch.ba.residuals import total_huber_cost_cuda

    dev = torch.device("cuda")
    takes_work = "work" in inspect.signature(S.linearize_cuda).parameters

    def linearize(name, a, kw):
        extra = {}
        if takes_work:
            B = 10 if a[2].dim() == 2 else 6
            extra = {"work": S.linearize_workspace(a[10], a[11], a[4], a[5], a[7], a[0].shape[0],
                                                   a[3].shape[0], B,
                                                   kw.get("dtype", torch.float32))}
        fn = lambda: S.linearize_cuda(*a, **kw, **extra)
        cargs = a[:8] + (a[12],)
        cost = lambda: total_huber_cost_cuda(*cargs)
        lin, c = fn(), cost()
        torch.cuda.synchronize()
        times = r.timed(fn, LIN_KERNELS)
        times.update({f"cost_{k}": v for k, v in r.timed(cost, ("ba_cost",)).items()})
        r.add(name, _digest(*(x for x in (*a, *kw.values()) if isinstance(x, torch.Tensor))),
              [getattr(lin, f) for f in LIN_OUTPUTS] + [c.reshape(1)],
              f"C={lin.U.shape[0]}, B={lin.U.shape[-1]}, {lin.U.dtype}, {a[4].shape[0]} rows, "
              f"{int(a[11].sum())} in the grouping", times, names=LIN_OUTPUTS + ("cost",))

    rvec, tvec, intr, pts, obs_cam, obs_point, obs_xy = cs.ba_scene(torch, np, dev)
    C, P, O = rvec.shape[0], pts.shape[0], obs_cam.shape[0]
    perm, pvm = S.coobs_pairs(obs_point.cpu().numpy(), np.ones(O, bool))
    perm, pvm = torch.as_tensor(perm, device=dev), torch.as_tensor(pvm, device=dev)
    cam_free = torch.ones(C, device=dev)
    cam_free[0] = 0.0
    linearize("linearize/phase_ba/default",
              (rvec, tvec, intr, pts, obs_cam, obs_point, obs_xy, torch.ones(O, device=dev),
               cam_free, torch.ones(P, dtype=torch.bool, device=dev), perm, pvm, 2.0, True,
               torch.eye(4, device=dev), torch.zeros(4, device=dev)), {})
    for route, (B, dname) in cs.ISLAND_ROUTES.items():
        a, kw = cs.island_system(torch, np, dev, B, getattr(torch, dname), *cs.ISLAND_SCENE, 0)
        linearize(f"linearize/phase_island/{route}", a, kw)
        torch.cuda.empty_cache()
    # The same scenes with rotations of ~0.4 rad: there R's last bit reaches
    # the outputs (small rotations round it away next to the identity).
    big = lambda C: torch.as_tensor(
        (0.4 * np.random.default_rng(C).normal(size=(C, 3))).astype(np.float32), device=dev)
    linearize("linearize/large_rotation/default",
              (big(C), tvec, intr, pts, obs_cam, obs_point, obs_xy, torch.ones(O, device=dev),
               cam_free, torch.ones(P, dtype=torch.bool, device=dev), perm, pvm, 2.0, True,
               torch.eye(4, device=dev), torch.zeros(4, device=dev)), {})
    for route, (B, dname) in cs.ISLAND_ROUTES.items():
        a, kw = cs.island_system(torch, np, dev, B, getattr(torch, dname), *cs.ISLAND_SCENE, 0)
        linearize(f"linearize/large_rotation/{route}", (big(a[0].shape[0]),) + tuple(a[1:]), kw)
        torch.cuda.empty_cache()
    if args.inputs:
        ba = torch.load(Path(args.inputs) / "run_ba.pt", weights_only=False)
        opt = ba["kwargs"].get("optimize_intrinsics", True)
        linearize("linearize/path_d/largest_run_ba",
                  run_ba_args(torch, np, S, lm, ba["problem"], ba["config"], opt, dev), {})


def ragged_descriptors(torch, dev, B, K1, K2, D, seed):
    """Unit descriptors at shapes the tiles must mask: K1 != K2, ragged
    tails, every 7th row and 5th column invalid, pair 0's rows all invalid
    and pair 1's columns; exact ties from rows copied twice into the other
    set (columns 3 i + 1 and 3 i + 2 are row i)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    unit = lambda x: x / x.norm(dim=-1, keepdim=True)
    d1 = unit(torch.randn(B, K1, D, generator=g, device=dev))
    d2 = unit(torch.randn(B, K2, D, generator=g, device=dev))
    n = min(len(range(1, K2, 3)), K1)
    d2[:, 1:3 * n:3] = d1[:, :n]
    m = len(range(2, min(3 * n, K2), 3))
    d2[:, 2:3 * n:3] = d1[:, :m]
    v1 = torch.ones(B, K1, dtype=torch.bool, device=dev)
    v2 = torch.ones(B, K2, dtype=torch.bool, device=dev)
    v1[:, ::7] = False
    v2[:, ::5] = False
    v1[0] = False
    v2[1 % B] = False
    return d1.contiguous(), v1, d2.contiguous(), v2


def run_match(r: Runner, args):
    torch, cs = r.torch, r.cs

    from sfm_tpu_torch.matching.core import match_top2_cuda

    dev = torch.device("cuda")

    def match(name, d1, v1, d2, v2):
        fn = lambda: match_top2_cuda(d1, v1, d2, v2, mutual=True)
        outs = fn()
        torch.cuda.synchronize()
        r.add(name, _digest(d1, v1, d2, v2), list(outs),
              f"B={d1.shape[0]}, K1={d1.shape[1]}, K2={d2.shape[1]}, D={d1.shape[2]}",
              r.timed(fn, ("match_top2",)), names=("idx", "best", "second", "back"))

    match("match/phase_match_top2/random", *cs.sweep_descriptors(torch, dev, 32, 2048, 128, 1))
    match("match/phase_match_top2/tie_heavy", *cs.tie_heavy_descriptors(torch, dev, 8, 2048))
    d1, v1, d2, v2 = cs.sweep_descriptors(torch, dev, 32, 3800, 256, 10)
    match("match/phase_match_binary/d256", cs.binary_descriptors(torch, d1), v1,
          cs.binary_descriptors(torch, d2), v2)
    del d1, d2
    for B, K1, K2, D in ((4, 2047, 1501, 96), (3, 3800, 2047, 256), (2, 700, 900, 384)):
        match(f"match/ragged/{B}x{K1}x{K2}x{D}",
              *ragged_descriptors(torch, dev, B, K1, K2, D, seed=K1 + D))
    for name in ("match_d", "match_g"):
        f = Path(args.inputs or "") / f"{name}.pt"
        if args.inputs and f.exists():
            m = torch.load(f, weights_only=False)
            match(f"match/path_{name[-1]}/first_chunk", *(m[k].to(dev) for k in
                                                          ("d1", "v1", "d2", "v2")))
    torch.cuda.empty_cache()


def run(args) -> int:
    repo = Path(args.repo).resolve()
    sys.path.insert(0, str(repo))
    import torch

    import chip_smoke as cs
    from sfm_tpu_torch.ba import schur as S
    from sfm_tpu_torch.reconstruction import incremental as inc

    if not torch.cuda.is_available():
        raise SystemExit("bits_report: needs a card")
    cases = args.cases.split(",")
    if not set(cases) <= set(CASES):
        raise SystemExit(f"bits_report: --cases takes {', '.join(CASES)}")
    r = Runner(torch, cs, S, inc)
    for case, fn in (("matvec", run_matvec), ("coupling", run_coupling),
                     ("triangulate", run_triangulate), ("linearize", run_linearize),
                     ("match", run_match)):
        if case in cases:
            fn(r, args)
    torch.save({"repo": str(repo), "card": cs.card_line(), "cases": r.cases,
                "failures": r.failures}, args.out)
    return 0


def compare(args) -> int:
    import torch

    a, b = (torch.load(p, weights_only=False) for p in (args.a, args.b))
    print(f"A: {a['repo']} ({a['card']}); B: {b['repo']} ({b['card']})")
    bits = lambda t: t.view({torch.float64: torch.int64, torch.float32: torch.int32}.get(
        t.dtype, t.dtype))
    fmt = lambda x: "not measured" if x is None else f"{x:.4f}"
    same_failures = torch.equal(a["failures"], b["failures"])
    rows, same = [], same_failures
    matched = set()
    for name, rb in b["cases"].items():
        ra = a["cases"].get(rb["ref"])
        if ra is None:
            print(f"{name} ({rb['shape']}): only in B")
            continue
        matched.add(rb["ref"])
        eq_in = ra["digest_in"] == rb["digest_in"]
        eq_out = all(torch.equal(bits(x), bits(y)) for x, y in zip(ra["out"], rb["out"]))
        per = [int((bits(x) != bits(y)).sum()) for x, y in zip(ra["out"], rb["out"])]
        diff = sum(per)
        names = rb.get("names") or [str(i) for i in range(len(per))]
        which = ", ".join(f"{k} {v}" for k, v in zip(names, per) if v)
        same = same and eq_in and eq_out
        times = "; ".join(f"{k} A {fmt(ra['times'].get(k))} / B {fmt(v)} ms"
                          for k, v in rb["times"].items())
        outs = "identical" if eq_out else f"NOT identical ({diff} entries differ: {which})"
        print(f"{name} ({rb['shape']}; A: {rb['ref']}): inputs {'equal' if eq_in else 'DIFFER'}, "
              f"outputs {outs}; {times}")
        rows.append({"case": name, "against": rb["ref"], "inputs_equal": eq_in,
                     "identical": eq_out, "entries_differing": diff,
                     "times": {k: [ra["times"].get(k), v] for k, v in rb["times"].items()}})
    for name in a["cases"]:
        if name not in matched:
            same = False
            print(f"{name}: only in A")
    print(json.dumps({"identical": same, "same_failures": same_failures, "cases": rows}))
    return 0 if same else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("dump")
    d.add_argument("--scene", required=True, help="path d's rendered scene")
    d.add_argument("--pipeline", required=True, help="path d's pipeline output (pair_table.pkl)")
    d.add_argument("--orb", default=None, help="path g's pipeline output (pair_table.pkl)")
    d.add_argument("--out", required=True)
    r = sub.add_parser("run")
    r.add_argument("--repo", required=True, help="the checkout whose kernels run")
    r.add_argument("--cases", default=",".join(CASES), help="a comma-separated subset of "
                   + ", ".join(CASES))
    r.add_argument("--inputs", default=None,
                   help="what dump wrote (without it, the kernel phases' scenes only)")
    r.add_argument("--vectors", type=int, default=8, help="the matvec's random x")
    r.add_argument("--out", required=True)
    c = sub.add_parser("compare")
    c.add_argument("a")
    c.add_argument("b")
    args = ap.parse_args(argv)
    return {"dump": dump, "run": run, "compare": compare}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
