"""Command-line interface of the port: the ``preprocess`` subcommand.

    python -m sfm_tpu_torch preprocess --data_dir D [--device cuda] [flags]

Counterpart of ``sfm_tpu/cli.py`` for the stages ported so far; the flags
mean what they mean there, plus ``--device`` (default ``cuda``; asking for
CUDA without a card raises).
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import logging.handlers
import sys
import time
from pathlib import Path

from sfm_tpu_torch._shared import SfMConfig
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


def _add_match_mode(p: argparse.ArgumentParser):
    p.add_argument("--feature_kind", default=None, choices=["sift", "orb"],
                   help="frontend class ('orb' is not ported yet)")
    p.add_argument("--match_mode", default=None,
                   choices=["off", "auto", "on", "sequential"],
                   help="candidate-pair preselection; only the exhaustive "
                        "sweep is ported, so 'on'/'sequential' (and 'auto' at "
                        ">= retrieval.auto_min_images images) raise")


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
    _add_match_mode(pre)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    setup_logging(args.log_level, args.log_dir)
    log = logging.getLogger("sfm_tpu_torch.cli")

    import numpy
    import torch

    log.info("python %s | torch %s (cuda %s) | numpy %s", sys.version.split()[0],
             torch.__version__, torch.version.cuda, numpy.__version__)
    pargs = PipelineArgs(
        data_dir=args.data_dir,
        output_dir=args.output_dir,
        start_idx=args.start_idx,
        end_idx=args.end_idx,
        use_mask=not args.no_mask,
        trace_dir=args.trace_dir,
        device=args.device,
    )
    try:
        cfg = SfMConfig.from_json(args.config_json) if args.config_json else SfMConfig()
        if args.match_mode:
            cfg = cfg.replace(
                retrieval=dataclasses.replace(cfg.retrieval, mode=args.match_mode))
        if args.feature_kind:
            cfg = cfg.replace(
                features=dataclasses.replace(cfg.features, kind=args.feature_kind))
        pipe = SfMPipeline(pargs, cfg)
        return 0 if pipe.run_preprocessing() else 1
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
