"""``python -m sfm_tpu_torch`` entry point."""
import sys

from sfm_tpu_torch.cli import main

sys.exit(main())
