"""Host time a batch of the single ``EngineExecutor`` that the device does
not hide: the traced window's ms a batch minus the device's busy ms a
batch. The executor's loop (quantize-in, stack, enqueue, collect) sets
the closed-loop rate wherever this is above 0."""


def read(t):
    if t.entry != "engine" or not t.batches or t.busy_s <= 0:
        return None
    return 1e3 * (t.window_s - t.busy_s) / t.batches
