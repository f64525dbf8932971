"""The 90th percentile of every request's latency in the window, in ms:
from the send to the device synchronisation that ends the request (host
clock), linear between the two nearest ranks."""


def read(run):
    lat = sorted(run.latencies_s)
    if run.traffic["kind"] != "prefill" or not lat:
        return None
    at = 0.9 * (len(lat) - 1)
    lo = int(at)
    hi = min(lo + 1, len(lat) - 1)
    return 1e3 * (lat[lo] + (lat[hi] - lat[lo]) * (at - lo))
