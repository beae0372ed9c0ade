"""Which of the program's launch spans held a CUDA graph replay: of the
traced window's ``engine.enqueue`` spans (the single executor's) and
``stage<i>.launch`` spans (a pipeline's stage workers'), the share that
holds a ``runner.replay`` span on its own thread, the runner's copy in,
replay and copy out of the batch's whole step range. A program whose
runners launch step by step records no ``runner.replay`` and reads 0; a
window without launch spans gives None."""

from __future__ import annotations

import collections

from bench.core import program_spans as PS


def _is_launch(name: str) -> bool:
    return name == "engine.enqueue" or (
        name.startswith("stage") and name.endswith(".launch"))


def share(t) -> float | None:
    rows = PS.rows(t)
    launches = [r for r in rows if _is_launch(r.name)]
    if not launches:
        return None
    replays = collections.defaultdict(list)
    for r in rows:
        if r.name == "runner.replay":
            replays[r.thread].append(r)
    held = sum(any(l.t0 <= r.t0 and r.t1 <= l.t1 for r in replays[l.thread])
               for l in launches)
    return 100.0 * held / len(launches)
