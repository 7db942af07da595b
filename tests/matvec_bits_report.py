"""K11's matvec of one checkout against another's, bit for bit, on the card.

    python tests/matvec_bits_report.py run --repo DIR --out FILE.pt [--vectors 8]
    python tests/matvec_bits_report.py compare A.pt B.pt

``run`` imports ``sfm_tpu_torch`` and ``chip_smoke`` from the checkout DIR
(so each checkout runs its own kernels, built from its own sources) and
builds the BA systems of ``chip_smoke.py``: the 300-camera / 600k-observation
PCG scene on the default route and on each island route (``pcg_system``,
``island_system``), the same systems with their observations in point-major
order (the engine's layout), and the 5,000-camera scene on every route
(``BIG_BA_SCENE``). On each it saves the bits of ``schur_matvec_cuda`` at
``--vectors`` random x and of a 50-step PCG solve (``pcg_solve_cuda``, tol 0),
a digest of the linearized system, and the matvec's wrapper time (median of
five means of 10 calls, the PCG loop's way: scratch made once where the
wrapper takes it), its device time (one ``torch.profiler`` trace) and the
50-step solve's time. ``compare`` prints, for each system, whether the two
checkouts' inputs and outputs are identical, and both checkouts' times, then
one JSON line. Two processes, since both checkouts' packages share a name.
Needs a card; the checkouts' own ``chip_smoke.py`` helpers do the timing.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib.util
import inspect
import json
import sys
from pathlib import Path


def _digest(torch, *tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        if t is not None:
            h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _point_major():
    """``chip_smoke.point_major`` of this checkout (the other checkout's
    ``chip_smoke`` may predate it): it takes the package's ``schur`` module
    as an argument, so it runs on either checkout's kernels."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.point_major


def run(args) -> int:
    repo = Path(args.repo).resolve()
    sys.path.insert(0, str(repo))
    import numpy as np
    import torch

    import chip_smoke as cs
    from sfm_tpu_torch.ba import schur as S

    point_major = _point_major()
    if not torch.cuda.is_available():
        raise SystemExit("matvec_bits_report: needs a card")
    dev = torch.device("cuda")
    takes_work = "work" in inspect.signature(S.schur_matvec_cuda).parameters
    out = {"repo": str(repo), "card": cs.card_line(), "systems": {}}
    routes = {"": (6, torch.float32), **{r: (B, getattr(torch, d))
                                          for r, (B, d) in cs.ISLAND_ROUTES.items()}}
    lam = 1e-3
    for scene in ("c300", "c300_point_major", "c5000"):
        for route, (B, dt) in routes.items():
            name = f"{scene}/{route or 'default'}"
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
            op, rhs_c, rhs_k = S.damp_operator(lin, lam, perm, pvm, precond=True)
            C = lin.U.shape[0]
            g = torch.Generator(device=dev).manual_seed(9)
            res = {"digest_in": _digest(torch, lin.Jc, lin.Jk, lin.Jp, lin.obs_cam,
                                        lin.obs_point, op.Vinv, op.lam_diag_c, op.lam_diag_k,
                                        perm, pvm),
                   "cameras": C, "valid_obs": int(pvm.sum())}
            extra = {}
            if takes_work:
                extra["work"] = S.matvec_workspace(lin, perm, pvm)
            outs = []
            for _ in range(args.vectors):
                xc = (1e-2 * torch.randn((C, B), device=dev, generator=g)).to(dt)
                xk = (1e-1 * torch.randn(4, device=dev, generator=g)).to(dt)
                outs.append(torch.cat([t.reshape(-1) for t in S.schur_matvec_cuda(
                    lin, op, xc, xk, perm, pvm, **extra)]))
            res["Sx"] = torch.stack(outs).cpu()
            pcg = lambda: S.pcg_solve_cuda(lin, op, rhs_c, rhs_k, perm, pvm, 50, 0.0, **extra)
            xc_, xk_, steps = pcg()
            res["pcg"] = torch.cat([xc_.reshape(-1), xk_]).cpu()
            res["pcg_steps"] = int(steps)
            mv = lambda: S.schur_matvec_cuda(lin, op, xc, xk, perm, pvm, **extra)
            res["wrapper_ms"] = cs.median_ms(torch, mv)
            res["device_ms"] = cs.device_ms(torch, mv)
            res["pcg50_ms"] = cs.median_ms(torch, pcg, batches=3, reps=3)
            out["systems"][name] = res
            print(f"{name}: C={C}, {res['valid_obs']} valid observations, matvec wrapper "
                  f"{res['wrapper_ms']:.4f} ms, device {cs.fmt_ms(res['device_ms'])}, 50-step "
                  f"PCG {res['pcg50_ms']:.4f} ms", flush=True)
            del lin, lin0, op, extra
            torch.cuda.empty_cache()
    torch.save(out, args.out)
    return 0


def compare(args) -> int:
    import torch

    a, b = (torch.load(p) for p in (args.a, args.b))
    print(f"A: {a['repo']} ({a['card']}); B: {b['repo']} ({b['card']})")
    rows, same = [], True
    for name, ra in a["systems"].items():
        rb = b["systems"][name]
        eq_in = ra["digest_in"] == rb["digest_in"]
        bits = lambda t: t.view(torch.int64) if t.dtype == torch.float64 else t.view(torch.int32)
        eq_sx = torch.equal(bits(ra["Sx"]), bits(rb["Sx"]))
        eq_pcg = torch.equal(bits(ra["pcg"]), bits(rb["pcg"])) and ra["pcg_steps"] == rb[
            "pcg_steps"]
        diff = int((bits(ra["Sx"]) != bits(rb["Sx"])).sum())
        same = same and eq_in and eq_sx and eq_pcg
        fmt = lambda x: "not measured" if x is None else f"{x:.4f}"
        sx = "bit-identical" if eq_sx else f"{diff} entries differ"
        print(f"{name}: inputs {'equal' if eq_in else 'DIFFER'}, S x {sx} "
              f"over {ra['Sx'].shape[0]} vectors of {ra['Sx'].shape[1]}, 50-step PCG "
              f"{'bit-identical' if eq_pcg else 'DIFFERS'}; matvec wrapper A {ra['wrapper_ms']:.4f}"
              f" / B {rb['wrapper_ms']:.4f} ms, device A {fmt(ra['device_ms'])} / B "
              f"{fmt(rb['device_ms'])} ms, PCG A {ra['pcg50_ms']:.4f} / B {rb['pcg50_ms']:.4f} ms")
        rows.append({"system": name, "inputs_equal": eq_in, "sx_equal": eq_sx,
                     "pcg_equal": eq_pcg, "sx_entries_differing": diff,
                     "wrapper_ms": [ra["wrapper_ms"], rb["wrapper_ms"]],
                     "device_ms": [ra["device_ms"], rb["device_ms"]],
                     "pcg50_ms": [ra["pcg50_ms"], rb["pcg50_ms"]]})
    print(json.dumps({"identical": same, "systems": rows}))
    return 0 if same else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("--repo", required=True, help="the checkout whose kernels run")
    r.add_argument("--out", required=True)
    r.add_argument("--vectors", type=int, default=8)
    c = sub.add_parser("compare")
    c.add_argument("a")
    c.add_argument("b")
    args = ap.parse_args(argv)
    return run(args) if args.cmd == "run" else compare(args)


if __name__ == "__main__":
    sys.exit(main())
