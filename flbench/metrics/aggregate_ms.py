"""aggregate_ms: host milliseconds a round in the span ``fl/aggregate``
(FedAvg of the kept uplinks), the mean over the traced window's
rounds."""


def read(ctx):
    got = ctx["spans"].get("fl/aggregate")
    if not got:
        return None
    return 1e3 * sum(got) / ctx["window_rounds"]
