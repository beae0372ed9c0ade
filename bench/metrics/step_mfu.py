"""The whole engine step's share of the card's int8 peak: the operations
of the frames completed in the traced window (2 x MACs a frame) over the
window's seconds and the published peak."""


def read(t):
    if t.peak_ops is None or not t.frames or t.window_s <= 0:
        return None
    return 100.0 * t.frames * t.ops_per_frame / t.window_s / t.peak_ops
