"""The MTL window's share with no operation on the card, from the
trace of CUDA activity, in %."""


def read(rec):
    if rec.trace is None or not rec.trace["window_s"]:
        return None
    return 100.0 * (1.0 - rec.trace["busy_s"] / rec.trace["window_s"])
