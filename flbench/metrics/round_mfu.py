"""round_mfu: the model FLOPs of the active client-steps of the
device-only profiled slice's rounds (FLOPs an image of the reference's
training step times the batch; masked steps are not counted) over its
wall time times the card's fp32 peak, in %."""


def read(ctx):
    sl, pk = ctx["slice_device"], ctx["peaks"]
    if not pk or sl["wall_s"] <= 0 or ctx["active_client_steps"] <= 0:
        return None
    flops = ctx["active_client_steps"] * ctx["batch"] \
        * ctx["flops_per_image"]
    return 100.0 * flops / (sl["wall_s"] * pk["fp32_flops_per_s"])
