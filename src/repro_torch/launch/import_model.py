"""Import an arbitrary CNN into the serving zoo: the compiler CLI.
PyTorch twin of ``repro/launch/import_model.py``.

The one-command front door over ``repro_torch.compiler``: read a model
description (a ``.json`` graph spec, or a ``.onnx`` file when the
optional ``onnx`` package is installed), lower it onto the engine
contract, quantize it with the shared serving conventions, generate +
cross-check its int8 golden parity record (exact-f32 generate, int32
oracle verify — the same bit-identical-routes contract the paper models
keep), and finish with a short serve smoke through
:func:`repro_torch.serving.build_server` so "imported" means *served*,
not just compiled. It runs on the GPU (the serve smoke through the
``gemm_int8`` kernel) unless ``--device`` names another device.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.import_model examples/lenet.json
  PYTHONPATH=src python -m repro_torch.launch.import_model \
      --spec examples/lenet.json --device cpu
  PYTHONPATH=src python -m repro_torch.launch.import_model \
      examples/lenet.json --golden-out lenet_golden.npz \
      --serve-frames 0   # import+check only
  PYTHONPATH=src python -m repro_torch.launch.import_model model.onnx \
      --bits 16 --batch 8 --stages 2
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch import compiler
from repro_torch.core.program import resolve_device
from repro_torch.serving.server import (ProgramRegistry, ServerConfig,
                                        build_server, synthetic_stream_like)


def import_and_serve(source, *, name: str | None = None, bits: int = 8,
                     seed: int = 0, theta: int | None = None,
                     golden_check: bool = True, golden_out=None,
                     serve_frames: int = 8, batch: int = 4,
                     stages: int = 1, verbose: bool = True,
                     device=None) -> dict:
    """The CLI's engine, importable for tests: import -> golden-check ->
    serve smoke. Returns a result dict (model card + golden digest +
    serve outcomes). ``serve_frames=0`` skips the serve smoke.
    ``device`` defaults to ``cuda`` and raises without one."""
    device = resolve_device(device)
    t0 = time.perf_counter()
    graph = compiler.import_graph(source)
    model, params = compiler.lower_graph(graph, device=device)
    reg = ProgramRegistry()
    model_id, golden = reg.register_imported(
        graph, name=name, bits=bits, seed=seed, theta=theta,
        golden_check=golden_check, device=device)
    prog = reg.get(model_id)
    import_s = time.perf_counter() - t0
    if golden_out is not None:
        compiler.save_golden(golden_out, golden)
    result = {
        "model": model_id,
        "source": str(source) if not isinstance(source, dict) else "<dict>",
        "bits": bits,
        "seed": seed,
        "device": str(prog.device),
        "params": "imported" if params is not None else "seeded",
        "input_hw": model.input_hw,
        "input_ch": model.input_ch,
        "layers": [{"name": l.name, "kind": l.kind, "in_ch": l.in_ch,
                    "out_ch": l.out_ch, "k": l.kernel, "stride": l.stride}
                   for l in model.layers],
        "modeled_fps_alg1": round(prog.fps(), 3),
        "golden": {
            "acc_crc": int(golden["acc_crc"]),
            "acc_sample_head": [int(v) for v in golden["acc_sample"][:4]],
            "top1": [int(v) for v in golden["top1"]],
            "checked": bool(golden_check),
            "routes": "f32 -> oracle" if golden_check else "f32 only",
            "saved": str(golden_out) if golden_out is not None else None,
        },
        "import_s": round(import_s, 3),
    }
    if verbose:
        kinds = ", ".join(f"{l.name}({l.kind})" for l in model.layers)
        print(f"[import_model] {model_id}: {len(model.layers)} engine "
              f"layers [{kinds}] from {result['source']}")
        print(f"[import_model] golden acc_crc={result['golden']['acc_crc']}"
              + (" verified across MAC routes (f32 -> oracle)"
                 if golden_check else " (check skipped)"))
    if serve_frames > 0:
        frames = synthetic_stream_like(model, serve_frames, seed)
        cfg = ServerConfig(batch=batch, stages=stages, bits=bits,
                           seed=seed, theta=theta,
                           calib_frames=max(3 * batch, 12))
        with build_server(reg, cfg, verbose=False) as srv:
            reqs = [srv.submit(model_id, f) for f in frames]
            outs = [r.result(timeout=120.0) for r in reqs]
            outcomes = [r.outcome for r in reqs]
            stats = srv.stats()
            route = getattr(srv.runtime(model_id).executor, "route", None)
        result["serve"] = {
            "frames": serve_frames,
            "batch": batch,
            "stages": stages,
            "outcomes": sorted(set(outcomes)),
            "completed": stats["totals"]["completed"],
            "route": route,
            "steady_fps": stats["models"][model_id]["steady_fps"],
            "sample_top1": [int(np.asarray(o).reshape(-1).argmax())
                            if np.asarray(o).size > 1 else int(o)
                            for o in outs[:4]],
        }
        if verbose:
            print(f"[import_model] serve smoke: "
                  f"{result['serve']['completed']}/{serve_frames} frames "
                  f"completed through build_server "
                  f"(steady {result['serve']['steady_fps']:.2f} fps)")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("source", nargs="?", default=None,
                    help="model to import: a .json graph spec, or a "
                         ".onnx file (needs the optional onnx package)")
    ap.add_argument("--spec", default=None,
                    help="the model to import, as a flag (the same as "
                         "the positional source)")
    ap.add_argument("--name", default=None,
                    help="registry id (default: the spec's model name)")
    ap.add_argument("--bits", type=int, default=8, choices=(8, 16))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--theta", type=int, default=None,
                    help="DSP budget for the Algorithm-1 plan "
                         "(default: Table I convention for --bits)")
    ap.add_argument("--no-check", action="store_true",
                    help="skip the cross-route golden verification")
    ap.add_argument("--golden-out", default=None,
                    help="also save the golden record as .npz")
    ap.add_argument("--serve-frames", type=int, default=8,
                    help="serve smoke length (0 = import+check only)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--stages", type=int, default=1)
    ap.add_argument("--json", action="store_true",
                    help="print the full result dict as JSON")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; refuses to run "
                         "without one unless --device cpu)")
    args = ap.parse_args(argv)
    if (args.source is None) == (args.spec is None):
        ap.error("give the model to import once: as the positional "
                 "source or as --spec")

    result = import_and_serve(
        args.source or args.spec, name=args.name, bits=args.bits,
        seed=args.seed, theta=args.theta, golden_check=not args.no_check,
        golden_out=args.golden_out, serve_frames=args.serve_frames,
        batch=args.batch, stages=args.stages, verbose=True,
        device=args.device)
    if args.json:
        print(json.dumps(result, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
