"""device_idle: the share of the device-only profiled slice's wall time
in which no operation ran on the card (1 - union of the operations'
intervals / wall), in %."""


def read(ctx):
    sl = ctx["slice_device"]
    if sl["ops"] == 0 or sl["wall_s"] <= 0:
        return None
    return 100.0 * (1.0 - sl["busy_s"] / sl["wall_s"])
