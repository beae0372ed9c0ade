"""CNN serving launcher: stream frames through a compiled EngineProgram on
the GPU. PyTorch twin of ``repro/launch/serve_cnn.py``.

Serves any of the four paper models (vgg16 / alexnet / zf / yolo) either
through one :class:`repro_torch.core.executor.EngineExecutor` or through
the stage-pipelined serving subsystem (``--stages K``:
:class:`repro_torch.serving.PipelineExecutor` + the async
:class:`repro_torch.serving.AsyncFrontend`), reporting measured
steady-state FPS next to the Algorithm-1 predicted FPS of the same plan —
plus request latency percentiles for the async path.

With ``--qos`` (or ``--traffic-mix`` / ``--slo-ms``) the stream is a
mixed-traffic arrival process through the QoS frontend: priority lanes,
per-request deadlines with drop-on-SLO-miss, and per-class latency split
into queueing / assembly / compute, with the expedited flush and the
(default-on) estimated-wait admission control driven by an online EWMA
service-time estimate warm-started from the calibration pass. ``--knee``
instead runs the bracketing absolute-QPS sweep and reports the capacity
knee: the max sustained rate at which the interactive class misses its
SLO less than ``--miss-target`` of the time. ``--place-stages`` pins
stage i to ``cuda:(i % n)`` (transparent on one card). ``--replicas R``
(with ``--replica-mode pipeline|stage-shard``) serves through R routed
pipeline replicas (:class:`repro_torch.serving.ReplicaPool`); on one
card they share it. ``--bits 16`` serves the int16 engine through its
exact integer oracle (the ``gemm_int8`` kernel is int8).

The serving engine itself lives in :mod:`repro_torch.serving.server`.

  python -m repro_torch.launch.serve_cnn --model alexnet --frames 64 --batch 16
  python -m repro_torch.launch.serve_cnn --model alexnet --stages 2
  python -m repro_torch.launch.serve_cnn --model alexnet --stages 2 --qos \\
      --slo-ms 200 --traffic-mix "interactive:1:0.25:slo,batch:0:0.75"
  python -m repro_torch.launch.serve_cnn --model alexnet --stages 2 \\
      --device cpu --quick
  python -m repro_torch.launch.serve_cnn --model alexnet --bits 16 \\
      --device cpu --quick
"""

from __future__ import annotations

import argparse
import json

from repro_torch.core import workload as W
from repro_torch.serving.server import (serve, serve_async, serve_knee,
                                        serve_qos)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model", default="alexnet",
                    choices=sorted(W.CNN_MODELS))
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--bits", type=int, default=8, choices=(8, 16),
                    help="activation/weight bits (16: the oracle route)")
    ap.add_argument("--route", default=None,
                    choices=("f32", "oracle", "kernel"),
                    help="MAC lowering (default: kernel on cuda, f32 on cpu; "
                         "oracle at --bits 16)")
    ap.add_argument("--eager-frames", type=int, default=0,
                    help="also time N frames through the eager loop")
    ap.add_argument("--output", default="top1",
                    choices=("top1", "logits"))
    ap.add_argument("--stages", type=int, default=0,
                    help="serve through the K-stage pipelined subsystem "
                         "with the async frontend (0 = single-executor "
                         "path)")
    ap.add_argument("--max-wait-ms", type=float, default=None,
                    help="dynamic batcher flush timeout (async path; "
                         "default: one full-batch window at the arrival "
                         "rate)")
    ap.add_argument("--arrival-fps", type=float, default=None,
                    help="open-loop request rate (default: 70%% of the "
                         "measured pipeline throughput)")
    ap.add_argument("--place-stages", action="store_true",
                    help="pin stage i to cuda:(i %% n) (transparent on "
                         "one card)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="serve through R routed pipeline replicas "
                         "(ReplicaPool + least-estimated-wait router; "
                         "implies the pipelined subsystem)")
    ap.add_argument("--replica-mode", default="pipeline",
                    choices=("pipeline", "stage-shard"),
                    help="replica placement: whole pipeline per device, "
                         "or stages sharded across each replica's "
                         "contiguous device slice")
    ap.add_argument("--qos", action="store_true",
                    help="serve a mixed-traffic stream through the QoS "
                         "frontend (priority lanes + deadlines) and "
                         "report per-class phase-split latency")
    ap.add_argument("--knee", action="store_true",
                    help="bracketing absolute-QPS sweep: report the max "
                         "sustained rate with interactive miss rate "
                         "under --miss-target (the capacity knee)")
    ap.add_argument("--miss-target", type=float, default=0.01,
                    help="armed-class SLO miss rate defining 'sustained' "
                         "for --knee (default 0.01)")
    ap.add_argument("--no-admission", action="store_true",
                    help="disable estimated-wait admission control "
                         "(lane-bound-only admission)")
    ap.add_argument("--flush-guard-ms", type=float, default=None,
                    help="fixed expedited-flush guard margin (default: "
                         "adaptive, 25%% of the service estimate + 2ms)")
    ap.add_argument("--traffic-mix", default=None,
                    help="QoS mix as name:priority:share[:deadline_ms] "
                         "comma-separated ('slo' = --slo-ms; default: "
                         "interactive:1:0.25:slo,batch:0:0.75)")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="deadline for the default interactive class "
                         "(implies --qos)")
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
    qos = args.qos or args.traffic_mix is not None or args.slo_ms is not None
    if args.knee or qos:
        from repro_torch.serving import parse_traffic_mix
        # slo_ms=None lets serve_qos derive a feasible deadline from
        # the measured service time; only an explicit --slo-ms pins it
        # (and is required when --traffic-mix uses the 'slo' token).
        mix = (parse_traffic_mix(args.traffic_mix, args.slo_ms)
               if args.traffic_mix else None)
    common = dict(frames=args.frames, batch=args.batch, bits=args.bits,
                  route=args.route, seed=args.seed, output=args.output,
                  device=args.device)
    if args.knee:
        result = serve_knee(
            args.model, stages=max(args.stages, 1), slo_ms=args.slo_ms,
            traffic_mix=mix, miss_target=args.miss_target,
            max_wait_ms=args.max_wait_ms,
            flush_guard_ms=args.flush_guard_ms,
            admission_control=not args.no_admission,
            place_stages=args.place_stages, replicas=args.replicas,
            replica_mode=args.replica_mode, **common)
    elif qos:
        result = serve_qos(
            args.model, stages=max(args.stages, 1), slo_ms=args.slo_ms,
            traffic_mix=mix, arrival_fps=args.arrival_fps,
            max_wait_ms=args.max_wait_ms,
            admission_control=not args.no_admission,
            flush_guard_ms=args.flush_guard_ms,
            place_stages=args.place_stages, replicas=args.replicas,
            replica_mode=args.replica_mode, **common)
    elif args.stages > 0 or args.replicas > 1:
        result = serve_async(
            args.model, stages=max(args.stages, 1),
            max_wait_ms=args.max_wait_ms, arrival_fps=args.arrival_fps,
            place_stages=args.place_stages, replicas=args.replicas,
            replica_mode=args.replica_mode, **common)
    else:
        result = serve(args.model, eager_frames=args.eager_frames,
                       **common)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
