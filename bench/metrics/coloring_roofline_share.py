"""Kernels: the share of the HBM roofline the device reaches on the work
the algorithm needs.  The bytes are counted by the benchmark from the graph
and the reference's record of each pass's colored and checked rows
(`bench/reference/work.py`), over the peak bandwidth of `bench/peaks.json`,
divided by the device's busy time a request; in percent.  Across cards the
work is the whole graph's and the bandwidth the cards' together."""


def read(record):
    nbytes, bw = record.get("work_bytes_per_request"), record.get("peak_bytes_per_s")
    busy, n = record.get("busy_s"), record.get("requests")
    if not (nbytes and bw and busy and n):
        return None
    return 100.0 * (nbytes / (bw * record["chips"])) / (busy / n)
