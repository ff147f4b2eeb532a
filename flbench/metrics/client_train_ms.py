"""client_train_ms: host milliseconds a round in the span
``fl/client_train`` (the vmapped cohort trainer, ending in the losses'
copy to the host, so its device work is inside), the mean over the
traced window's rounds."""


def read(ctx):
    got = ctx["spans"].get("fl/client_train")
    if not got:
        return None
    return 1e3 * sum(got) / ctx["window_rounds"]
