"""``python -m ray_tpu_torch`` → the CLI (see ``ray_tpu_torch/scripts/cli.py``)."""

import sys

from .scripts.cli import main

sys.exit(main())
