"""``python -m dpsvm_tpu_torch.tuning --selfcheck`` — the tuning layer's
gate."""

import sys

from dpsvm_tpu_torch.tuning import main

sys.exit(main())
