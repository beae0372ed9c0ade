"""Quantize-in (``CompiledRunner.quantize`` as the executors call it) ms a
batch, from the program's spans: ``engine.quantize`` in the single
executor, ``pipeline.quantize`` on a pipeline's submitting thread."""

from bench.core import program_spans as PS


def read(t):
    return PS.ms_a_batch(PS.named(t, ("engine.quantize",
                                     "pipeline.quantize")))
