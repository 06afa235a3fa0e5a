"""``python -m dpsvm_tpu_torch.approx --selfcheck`` — the kernel-
approximation subsystem's gate."""

import sys

from dpsvm_tpu_torch.approx import main

sys.exit(main())
