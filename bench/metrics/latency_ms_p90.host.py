"""Entry point: the 90th percentile of the traced window's request times, in
ms, each from call to return on the host clock (`statistics.quantiles`,
inclusive).  A steadier view of the tail sits beside `colorings_per_s`:
its spread between runs is too wide for a bound of its own."""
import statistics


def read(record):
    lat = record.get("latencies")
    if not lat:
        return None
    p90 = lat[0] if len(lat) == 1 else statistics.quantiles(lat, n=10, method="inclusive")[-1]
    return p90 * 1e3
