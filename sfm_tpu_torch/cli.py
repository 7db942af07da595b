"""Command-line interface of the port.

    python -m sfm_tpu_torch {preprocess|reconstruct|pipeline} --data_dir D
        [--device cuda] [flags]

Counterpart of ``sfm_tpu/cli.py``; the subcommands and flags mean what they
mean there, plus ``--device`` (default ``cuda``; asking for CUDA without a
card raises). ``--global_init`` and ``--polish`` set
``global_init.enabled`` / ``global_init.polish``. Flags of parts not ported
yet (``--checkpoint_dir`` / ``--resume_checkpoint``, ``--visualize``) raise
``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import logging.handlers
import sys
import time
from pathlib import Path

from sfm_tpu_torch.config import SfMConfig
from sfm_tpu_torch.pipeline import PipelineArgs, SfMPipeline


def setup_logging(log_level: str = "INFO", log_dir: str | None = None):
    """Console + 10MB x 5 rotating file logging."""
    handlers: list[logging.Handler] = [logging.StreamHandler()]
    if log_dir:
        d = Path(log_dir)
        d.mkdir(parents=True, exist_ok=True)
        ts = time.strftime("%Y%m%d_%H%M%S")
        handlers.append(
            logging.handlers.RotatingFileHandler(
                d / f"sfm_pipeline_{ts}.log", maxBytes=10 * 1024 * 1024, backupCount=5
            )
        )
    logging.basicConfig(
        level=getattr(logging, log_level.upper(), logging.INFO),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
        handlers=handlers,
        force=True,
    )


def _add_common(p: argparse.ArgumentParser):
    p.add_argument("--data_dir", required=True, help="dataset root (images/, silhouettes/)")
    p.add_argument("--output_dir", default=None, help="artifact root (default: data_dir)")
    p.add_argument("--no_mask", action="store_true", help="disable silhouette masking")
    p.add_argument("--trace_dir", default=None,
                   help="capture a torch.profiler Chrome trace into this dir")
    p.add_argument("--config", default=None, dest="config_json",
                   help="JSON file of SfMConfig overrides (the sfm_tpu schema)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda, cuda:N or cpu)")
    p.add_argument("--global_init", action="store_true",
                   help="global SfM: rotation + translation averaging instead of "
                        "incremental growth")
    p.add_argument("--polish", action="store_true",
                   help="pose-graph drift correction of the incremental model")


def _add_recon_flags(p: argparse.ArgumentParser):
    p.add_argument("--num_images", type=int, default=1000)
    p.add_argument("--min_matches", type=int, default=20)
    for name, default, help_ in (
            ("export_colmap", True, "COLMAP text model + database"),
            ("export_meshlab", True, "MeshLab PLY"),
            ("export_bundler", False, "Bundler v0.3 bundle.out + list.txt"),
            ("export_nvm", False, "VisualSFM NVM_V3 model")):
        p.add_argument(f"--{name}", action=argparse.BooleanOptionalAction,
                       default=default, help=help_)
    p.add_argument("--checkpoint_dir", default=None, help="not ported yet: raises")
    p.add_argument("--checkpoint_every", type=int, default=0)
    p.add_argument("--resume_checkpoint", default=None, help="not ported yet: raises")


def _add_match_mode(p: argparse.ArgumentParser):
    p.add_argument("--feature_kind", default=None, choices=["sift", "orb"],
                   help="frontend class: SIFT, or FAST + steered BRIEF (ORB-class)")
    p.add_argument("--match_mode", default=None,
                   choices=["off", "auto", "on", "sequential"],
                   help="candidate-pair preselection: 'off' sweeps every pair, "
                        "'on' scores every pair and sweeps the kept ones, "
                        "'auto' does so at >= retrieval.auto_min_images images, "
                        "'sequential' sweeps a window of neighbours")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="sfm_tpu_torch", description="Structure-from-Motion on PyTorch/CUDA")
    ap.add_argument("--log_level", default="INFO",
                    choices=["DEBUG", "INFO", "WARNING", "ERROR"])
    ap.add_argument("--log_dir", default="logs")
    sub = ap.add_subparsers(dest="command", required=True)
    pre = sub.add_parser("preprocess", help="feature detection + pair matching")
    _add_common(pre)
    pre.add_argument("--start_idx", type=int, default=0)
    pre.add_argument("--end_idx", type=int, default=999)
    pre.add_argument("--visualize", action="store_true", help="not ported yet: raises")
    _add_match_mode(pre)

    rec = sub.add_parser("reconstruct",
                         help="incremental reconstruction from saved artifacts")
    _add_common(rec)
    _add_recon_flags(rec)

    full = sub.add_parser("pipeline", help="preprocess + reconstruct")
    _add_common(full)
    full.add_argument("--start_idx", type=int, default=0)
    full.add_argument("--end_idx", type=int, default=999)
    full.add_argument("--visualize", action="store_true", help="not ported yet: raises")
    _add_recon_flags(full)
    _add_match_mode(full)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    setup_logging(args.log_level, args.log_dir)
    log = logging.getLogger("sfm_tpu_torch.cli")

    import numpy
    import torch

    log.info("python %s | torch %s (cuda %s) | numpy %s", sys.version.split()[0],
             torch.__version__, torch.version.cuda, numpy.__version__)
    opt = lambda name, default: getattr(args, name, default)
    pargs = PipelineArgs(
        data_dir=args.data_dir,
        output_dir=args.output_dir,
        start_idx=opt("start_idx", 0),
        end_idx=opt("end_idx", 999),
        num_images=opt("num_images", 1000),
        min_matches=opt("min_matches", 20),
        use_mask=not args.no_mask,
        export_colmap=opt("export_colmap", True),
        export_meshlab=opt("export_meshlab", True),
        export_bundler=opt("export_bundler", False),
        export_nvm=opt("export_nvm", False),
        visualize=opt("visualize", False),
        trace_dir=args.trace_dir,
        checkpoint_dir=opt("checkpoint_dir", None),
        checkpoint_every=opt("checkpoint_every", 0),
        resume_checkpoint=opt("resume_checkpoint", None),
        device=args.device,
    )
    try:
        cfg = SfMConfig.from_json(args.config_json) if args.config_json else SfMConfig()
        if pargs.min_matches != 20:
            cfg = cfg.replace(pnp=dataclasses.replace(cfg.pnp, min_matches=pargs.min_matches))
        if args.global_init:
            cfg = cfg.replace(
                global_init=dataclasses.replace(cfg.global_init, enabled=True))
        if args.polish:
            cfg = cfg.replace(global_init=dataclasses.replace(cfg.global_init, polish=True))
        if opt("match_mode", None):
            cfg = cfg.replace(
                retrieval=dataclasses.replace(cfg.retrieval, mode=args.match_mode))
        if opt("feature_kind", None):
            cfg = cfg.replace(
                features=dataclasses.replace(cfg.features, kind=args.feature_kind))
        pipe = SfMPipeline(pargs, cfg)
        if args.command == "preprocess":
            ok = pipe.run_preprocessing()
        elif args.command == "reconstruct":
            ok = pipe.run_reconstruction()
        else:
            ok = pipe.run_full_pipeline()
        return 0 if ok else 1
    except KeyboardInterrupt:
        log.error("interrupted")
        return 130
    except MemoryError:
        log.error("out of memory")
        return 137
    except (ValueError, FileNotFoundError) as e:
        log.error("%s", e)
        return 2


if __name__ == "__main__":
    sys.exit(main())
