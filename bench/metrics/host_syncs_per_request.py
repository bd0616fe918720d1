"""Loop driver (`core/distributed.py::_make_loop`,
`kernels/ops.py::_fixed_point`): host syncs with the device a request,
counted by `torch.cuda.set_sync_debug_mode` over the traced window."""


def read(record):
    syncs, n = record.get("syncs"), record.get("requests")
    return None if syncs is None or not n else syncs / n
