"""Exchange (`core/exchange.py`, `sparse_delta`): payload bytes a round
as the port counts them (`ColoringResult.comm_bytes_per_round`), mean over
the traced window; not the bytes NCCL moves."""


def read(record):
    payloads = record.get("payload_per_round")
    return sum(payloads) / len(payloads) if payloads else None
