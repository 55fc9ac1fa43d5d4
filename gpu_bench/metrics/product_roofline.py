"""The product's share of its bound: the configuration's frozen bytes at
the card's published bandwidth, over the device-busy time a product takes
in the traced window (every device op, whatever its name, divided by the
products there)."""


def read(run):
    if run.trace is None:
        return None
    bandwidth = run.peak("hbm_bytes_per_s")
    if bandwidth is None:
        return None
    busy_per_call = run.trace.busy_s / run.trace.calls
    return 100.0 * (run.bytes_per_call / bandwidth) / busy_per_call
