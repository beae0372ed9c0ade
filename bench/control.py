"""The control of the comparison that decides ``correct``, at a cell's own
size: the configuration family's plain reference computed at 4 bits, the
precision below the configuration's int8, put in the program's place and
held against the int8 reference by the harness's own comparison. It has to
come out as not correct. The benchmark's runs never run this.

    python3 bench/control.py --workload vgg16-b16-closed --seeds 1,2,3

Prints one JSON line per seed with the readings of the compared numbers.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CONTROL_BITS = 4


def readings(cell, seed: int, device) -> dict:
    """The comparison's readings of the cell's pool of frames, the
    family's reference at ``CONTROL_BITS`` against it at the
    configuration's bits."""
    import numpy as np

    from bench.core import compare, inputs

    cfg, fam, pool_size = cell.config, cell.family, cell.traffic["pool"]
    params = fam.make_params(cfg, seed, device)
    calib = inputs.make_calib(cfg, seed, device)
    frames = inputs.make_frames(cfg, pool_size, seed, device)
    ref = fam.logits(cfg, params, calib, frames, bits=cfg["bits"])
    low = fam.logits(cfg, params, calib, frames, bits=CONTROL_BITS)
    r = compare.compare(list(low), np.arange(pool_size), ref)
    return dict(r, correct=compare.correct(r))


def main(argv=None, *, device="cuda", root: Path = ROOT) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT)]
    from bench.core import spec
    cell = spec.cell(args.workload, root)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        row = dict(readings(cell, seed, device), workload=args.workload,
                   seed=seed)
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
