"""Graph partition (`graph/partition.py::partition_graph`): seconds of
the one call in set-up, on the harness's clock."""


def read(record):
    return record.get("partition_s")
