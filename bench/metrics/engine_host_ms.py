"""Host time a batch inside the single ``EngineExecutor``, from its own
spans: stack, quantize-in, stage-in, enqueue (the chain's launches and the
event record) and collect (dequantize, argmax, delivery), self time, ms a
batch; its event wait (``engine.wait``) left out. The inside twin of
``executor_exposed_host_ms``."""

from bench.core import program_spans as PS

NAMES = ("engine.stack", "engine.quantize", "engine.stage_in",
         "engine.enqueue", "engine.collect")


def read(t):
    rs = PS.named(t, NAMES)
    own = PS.self_seconds(rs)
    return PS.ms_a_batch(rs, lambda r: own[id(r)])
