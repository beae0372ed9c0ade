"""Training launcher, the port of ``repro/launch/train.py``: the data
stream, AdamW with the warmup-stable-decay schedule, checkpoints and the
restartable loop, on one device.

Example (CPU, reduced config):
  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --reduced \\
      --steps 20 --batch 8 --seq 64 --device cpu

Full width on the card (RecurrentGemma-2B: the RG-LRU's forward and
backward run through the ``linear_scan`` kernel):
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch recurrentgemma-2b --steps 5 --batch 2 --seq 1024

``main`` returns the run's record: every step's loss, gradient norm, wall
time and kernel launches (``linear_scan`` by direction, ``flash_attention``,
which a training step never launches), the restarts, and the final
``state`` (params, AdamW state) on the device.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import torch

from repro_torch import optim
from repro_torch.configs import get as get_arch
from repro_torch.configs.base import reduced as reduce_cfg
from repro_torch.data.pipeline import DataConfig, make_stream
from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.kernels.rglru_scan.kernel import linear_scan
from repro_torch.launch import steps as STEPS
from repro_torch.models import transformer as T
from repro_torch.runtime import fault_tolerance as FT


def _launches() -> dict:
    return {"linear_scan_forward": linear_scan.launches_by_path["forward"],
            "linear_scan_backward": linear_scan.launches_by_path["backward"],
            "flash_attention": flash_attention.launches}


def _init_state(cfg, seed: int, device) -> tuple:
    """(params, AdamW state) for ``cfg`` from ``seed`` on ``device``."""
    params = T.init_params(cfg, seed=seed, device=device)
    return params, optim.adamw_init(params, cfg.opt_moment_dtype)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the decoder's depth (as launch/serve.py's)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_ckpt"),
                    help="checkpoint directory; a run resumes from its "
                         "latest complete step")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0, help="weights seed")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; refuses to run "
                         "without one unless --device cpu)")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    if args.n_layers:
        cfg = cfg.scaled(n_layers=args.n_layers)
    device = T._device(args.device)
    n = T.param_count(cfg)
    print(f"[train] {cfg.name}: {n/1e6:.1f}M params, "
          f"{args.steps} steps @ batch {args.batch} x seq {args.seq}",
          flush=True)

    dc = DataConfig(global_batch=args.batch, seq_len=args.seq,
                    vocab=cfg.vocab)
    stream = make_stream(cfg, dc, device=device)
    lr = optim.wsd_schedule(args.lr, warmup=min(100, args.steps // 10 + 1),
                            total=args.steps)
    step = STEPS.make_train_step(cfg, lr=lr, remat=False)
    sync = torch.cuda.synchronize if device.type == "cuda" else (
        lambda: None)
    record = {"losses": [], "grad_norms": [], "step_ms": [],
              "launches": []}

    def wrapped(state, batch):
        params, opt_state = state
        before = _launches()
        sync()
        t0 = time.perf_counter()
        params, opt_state, m = step(params, opt_state, batch)
        sync()
        record["step_ms"].append((time.perf_counter() - t0) * 1e3)
        after = _launches()
        record["launches"].append({k: after[k] - before[k] for k in after})
        loss, gn = float(m["loss"]), float(m["grad_norm"])
        i = len(record["losses"])
        if i % args.log_every == 0:
            print(f"step {i:5d} loss {loss:.4f} gnorm {gn:.3f}", flush=True)
        record["losses"].append(loss)
        record["grad_norms"].append(gn)
        return (params, opt_state), m

    # The loop holds the only reference to the state, so a restart can let
    # it go before it reads the checkpoint.
    state, rs = FT.run_loop(
        state=_init_state(cfg, args.seed, device), step_fn=wrapped,
        stream=stream, ckpt_dir=args.ckpt, total_steps=args.steps,
        ckpt_every=args.ckpt_every)
    logged = record["losses"]
    if logged:
        print(f"[train] done: final loss {logged[-1]:.4f} "
              f"(first {logged[0]:.4f}), restarts={rs.restarts}",
              flush=True)
    return {"arch": cfg.name, "reduced": args.reduced, "params": n,
            "device": str(device), "batch": args.batch, "seq": args.seq,
            "steps": args.steps, "restarts": rs.restarts, **record,
            "state": state}


if __name__ == "__main__":
    out = main()
    print(json.dumps({k: out[k] for k in ("arch", "steps", "restarts",
                                          "losses", "grad_norms")}))
