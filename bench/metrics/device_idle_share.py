"""Device (H100): the share of the traced window in which no operation
ran on the device, `torch.profiler`, averaged over the cards; in percent."""


def read(record):
    busy, window = record.get("busy_s"), record.get("window_s")
    return 100.0 * (1.0 - busy / window) if busy and window else None
