"""pack_roofline: the least time of the round's uplink packs (B1's bytes,
``yardstick.b1_bytes``, at the card's HBM peak, once a kept client) over
the device time of every operation launched inside ``fl/pack``, in %,
in the host-side profiled slice. Nothing to read on an fp32 wire."""


def read(ctx):
    sl, pk = ctx["slice_host"], ctx["peaks"]
    if ctx["b1_bytes"] is None or not pk:
        return None
    dev = sl["by_span"].get("fl/pack", {}).get("device_s", 0.0)
    if dev <= 0:
        return None
    least = sl["rounds"] * ctx["packs_per_round"] * ctx["b1_bytes"] \
        / pk["hbm_bytes_per_s"]
    return 100.0 * least / dev
