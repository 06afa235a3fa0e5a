"""``python -m dpsvm_tpu_torch.observability --selfcheck [--device cpu]``
and ``--validate TRACE``."""

import sys

from dpsvm_tpu_torch.observability import main

sys.exit(main())
