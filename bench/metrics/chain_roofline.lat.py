"""The engine graph's share of its roofline in an open-loop cell: the
least time of the batches run in the traced window (each layer's larger
bound of operations over the int8 peak and bytes over HBM bandwidth, from
the family's counts: bench/roofline/resnet_counts.py for a residual
graph, its skips' reads in the fused epilogue included) over the device's
busy time in it. ``chain_roofline``'s formula."""


def read(t):
    if t.least_batch_s is None or not t.batches or t.busy_s <= 0:
        return None
    return 100.0 * t.batches * t.least_batch_s / t.busy_s
