"""Entry point, host I/O (`ColoringPlan.request_inputs` + `_result`):
milliseconds a request spends in the two, mean over the traced window."""


def read(record):
    io = record.get("host_io_s")
    return None if io is None else io * 1e3
