"""Kernels (`kernels/ops.py`, `csrc/*.cu`): milliseconds the device is
busy a request (the union of its operations in the `torch.profiler` trace
over the window, averaged over the cards), over the traced window."""


def read(record):
    busy, n = record.get("busy_s"), record.get("requests")
    return busy / n * 1e3 if busy and n else None
