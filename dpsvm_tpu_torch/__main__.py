"""``python -m dpsvm_tpu_torch train|test ...`` — the port's CLI."""

import sys

from dpsvm_tpu_torch.cli import main

sys.exit(main())
