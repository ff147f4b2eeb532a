"""aggregate_roofline: the least time of the round's reduce (B2's bytes
at K, ``yardstick.b2_bytes``, at the card's HBM peak) over the device
time of every operation launched inside ``fl/aggregate``, in %, in the
host-side profiled slice. Nothing to read on an fp32 wire."""


def read(ctx):
    sl, pk = ctx["slice_host"], ctx["peaks"]
    if ctx["b2_bytes"] is None or not pk:
        return None
    dev = sl["by_span"].get("fl/aggregate", {}).get("device_s", 0.0)
    if dev <= 0:
        return None
    least = sl["rounds"] * ctx["b2_bytes"] / pk["hbm_bytes_per_s"]
    return 100.0 * least / dev
