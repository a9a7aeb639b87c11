"""``python -m copycat_tpu_torch.analysis`` — same surface as ``python -m
copycat_tpu_torch.cli lint`` (torch-free; see docs/ANALYSIS.md)."""

import sys

from .engine import main

if __name__ == "__main__":
    sys.exit(main())
