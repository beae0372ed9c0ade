"""Runs the harness on a tiny checkout on the CPU, in a process of its
own (the harness refuses to report from a process where JAX is loaded,
and test workers load it), optionally with a fault planted:

    python -m bench.tests.drive_tiny <tiny checkout> <cell> <trace> [fault]
"""

from __future__ import annotations

import sys
from pathlib import Path

if __name__ == "__main__":
    root, cell, trace = Path(sys.argv[1]), sys.argv[2], sys.argv[3]
    if len(sys.argv) > 4:
        from bench.tests import faults
        faults.install(sys.argv[4])
    from bench import run
    run.main(["--workload", cell, "--seed", str(2 ** 31 + 11),
              "--seconds", "0.6", "--trace", trace], device="cpu", root=root)
