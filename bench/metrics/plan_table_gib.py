"""Plan: the bytes the cached plan pins (`ColoringPlan.nbytes`, the
port's own count of its device tables and host gather tables), in GiB."""


def read(record):
    nbytes = record.get("plan_table_bytes")
    return None if nbytes is None else nbytes / 2**30
