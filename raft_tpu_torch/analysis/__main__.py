"""Entry point for ``python -m raft_tpu_torch.analysis``."""

import sys

from raft_tpu_torch.analysis.cli import main

sys.exit(main())
