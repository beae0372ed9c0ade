"""Off-CPU time of the busiest stage worker's launches, ms a batch: of the
stage whose ``stage<i>.launch`` spans (stage 0's copy in, the runner's
launches, the event record) hold the most wall time, their wall time less
the thread's CPU seconds in them: waiting for the GIL or descheduled."""

from bench.core import program_spans as PS


def read(t):
    return PS.busiest_launch_offcpu_ms(t)
