"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: ``None``
means ``cuda``, and a missing card is an error, never a quiet move to the
CPU. The CPU runs the plain PyTorch versions of the kernels; it is what
the tests ask for with ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: dpsvm_tpu_torch runs on the GPU by "
            "default. Pass device='cpu' (CLI: --device cpu) to run the "
            "plain PyTorch path on the CPU.")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {dev}")
    return dev
