"""Host-side device facts: the allocator's memory watermarks (port of
``dpsvm_tpu/observability/device.py``).

``torch.cuda.memory_stats`` reads the caching allocator's books on the
host and the card's total memory is a cached device property; neither
synchronizes the stream nor copies from the device, so
sampling them at the existing poll boundary adds no device-to-host
transfer. On the CPU every field is null, as the JAX package reports a
backend without allocator stats: the keys are the schema's contract, not
their values.

``in_use`` and ``peak`` are the bytes PyTorch's allocator holds for
tensors now and at most since the process started (or the last
``torch.cuda.reset_peak_memory_stats``); ``limit`` is the card's total
memory.
"""

from __future__ import annotations


def memory_snapshot(device=None) -> dict:
    """{"in_use": bytes|None, "peak": bytes|None, "limit": bytes|None}
    for ``device`` (default: the current CUDA device when there is one).
    Never raises: a CPU device, or no card, reports nulls."""
    empty = {"in_use": None, "peak": None, "limit": None}
    try:
        import torch

        dev = torch.device(device) if device is not None else (
            torch.device("cuda", torch.cuda.current_device())
            if torch.cuda.is_available() else torch.device("cpu"))
        if dev.type != "cuda" or not torch.cuda.is_available():
            return empty
        stats = torch.cuda.memory_stats(dev)
        total = torch.cuda.get_device_properties(dev).total_memory
    except Exception:
        return empty

    def grab(name):
        v = stats.get(name)
        return int(v) if v is not None else None

    return {"in_use": grab("allocated_bytes.all.current"),
            "peak": grab("allocated_bytes.all.peak"),
            "limit": int(total)}
