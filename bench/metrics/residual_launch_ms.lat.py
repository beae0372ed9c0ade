"""Host time of the bottlenecks' launches, ms a batch: the program's
``residual.launch`` spans (each around one bottleneck's launches, inside
its stage's ``stage<i>.launch``, whose owner and batch it carries), wall
time summed over the traced window's spans and divided by the batches
they carry. A program without the span gives nothing."""

from bench.core import program_spans as PS


def read(t):
    return PS.ms_a_batch(PS.named(t, ("residual.launch",)))
