"""pack_ms: host milliseconds a round in the span ``fl/pack`` (each
kept client's uplink encoded), the mean over the traced window's
rounds."""


def read(ctx):
    got = ctx["spans"].get("fl/pack")
    if not got:
        return None
    return 1e3 * sum(got) / ctx["window_rounds"]
