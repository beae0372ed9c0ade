"""Share of the traced window's launch spans (``engine.enqueue``,
``stage<i>.launch``) that hold a ``runner.replay`` span: the batches whose
step range ran as one CUDA graph replay (bench/core/graph_replay.py)."""

from bench.core import graph_replay


def read(t):
    return graph_replay.share(t)
