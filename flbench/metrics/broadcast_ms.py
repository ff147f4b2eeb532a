"""broadcast_ms: host milliseconds a round in the span ``fl/broadcast``
(the downlink, the cohort's batch gather and its upload), the mean over
the traced window's rounds."""


def read(ctx):
    got = ctx["spans"].get("fl/broadcast")
    if not got:
        return None
    return 1e3 * sum(got) / ctx["window_rounds"]
