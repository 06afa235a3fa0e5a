"""``python -m dpsvm_tpu_torch.data --selfcheck`` — the streaming-data
gate."""

import sys

from dpsvm_tpu_torch.data import main

sys.exit(main())
