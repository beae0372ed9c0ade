"""The pipeline's beat: the busiest stage worker's ms a batch
(``PipelineExecutor.stage_busy_s`` over the batches of the traced window;
a stage's busy time includes its wait on its own CUDA event)."""

from bench.core.trace import stage_beat_ms


def read(t):
    return stage_beat_ms(t)
