"""Kernel launches a batch of the detect core: every count of
`tpudf_torch.core.backend.LAUNCHES` over the window (a wrapper counts
each launch of its kernel on the card), over the window's batches."""


def read(rec):
    batches = rec.window.work.get("batches")
    if not batches or not rec.window.launches:
        return None
    return sum(rec.window.launches.values()) / batches
