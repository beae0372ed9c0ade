"""CNN serving launcher: stream frames through a compiled EngineProgram on
the GPU. Twin of the single-executor path of ``repro/launch/serve_cnn.py``.

Serves any of the four paper models (vgg16 / alexnet / zf / yolo) through
one :class:`repro_torch.core.executor.EngineExecutor`, reporting measured
steady-state FPS next to the Algorithm-1 predicted FPS of the same plan.
The stage-pipelined, QoS, knee and replica paths of the reference are not
ported yet, and their flags are refused.

  python -m repro_torch.launch.serve_cnn --model alexnet --frames 64 --batch 16
"""

from __future__ import annotations

import argparse
import json

from repro_torch.core import workload as W
from repro_torch.serving.server import serve


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model", default="alexnet",
                    choices=sorted(W.CNN_MODELS))
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--route", default=None,
                    choices=("f32", "oracle", "kernel"),
                    help="MAC lowering (default: kernel on cuda, f32 on cpu)")
    ap.add_argument("--eager-frames", type=int, default=0,
                    help="also time N frames through the eager loop")
    ap.add_argument("--output", default="top1",
                    choices=("top1", "logits"))
    ap.add_argument("--seed", type=int, default=0,
                    help="params/calibration/stream RNG seed")
    ap.add_argument("--quick", action="store_true",
                    help="small smoke setting (8 frames, batch 4)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; refuses to run "
                         "without one unless --device cpu)")
    args = ap.parse_args(argv)
    if args.quick:
        args.frames, args.batch = 8, 4
    result = serve(args.model, frames=args.frames, batch=args.batch,
                   route=args.route, seed=args.seed,
                   eager_frames=args.eager_frames, output=args.output,
                   device=args.device)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
