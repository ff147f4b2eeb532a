"""train_launches_per_step: kernel launches inside ``fl/client_train``
over the cohort steps computed (the schedule's steps a round, masked
ones included: the vmapped cohort computes every client at each step),
in the host-side profiled slice."""


def read(ctx):
    sl = ctx["slice_host"]
    n = sl["by_span"].get("fl/client_train", {}).get("launches", 0)
    steps = sl["rounds"] * ctx["schedule_steps"]
    if n <= 0 or steps <= 0:
        return None
    return n / steps
