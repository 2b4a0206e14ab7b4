"""Seconds of the port's build call in set-up (calibration, quantisation
and the kernels' layout; or the trainer's init), ending in a synchronise:
the harness's "build" span."""


def read(rec):
    return rec.spans.seconds("build")
