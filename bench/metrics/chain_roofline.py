"""The engine chain's share of its roofline: the least time of the batches
run in the traced window (each layer's larger bound of operations over
the int8 peak and bytes over HBM bandwidth, bench/roofline/counts.py,
from the layers' shapes alone) over the device's busy time in it."""


def read(t):
    if t.least_batch_s is None or not t.batches or t.busy_s <= 0:
        return None
    return 100.0 * t.batches * t.least_batch_s / t.busy_s
