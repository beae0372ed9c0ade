"""Serving launcher for the LM substrate: batched prefill + greedy decode
over the KV cache, the port of ``repro/launch/serve.py`` for every family.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \\
      --batch 4 --prompt-len 512 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b \\
      --batch 4 --prompt-len 512 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --reduced \\
      --device cpu

(also ``--arch qwen2-vl-2b``, ``seamless-m4t-medium``, ``deepseek-v2-236b``
or ``rwkv6-7b``, and the rest of ``configs/``).

Inputs, as in the reference: token prompts; for the VLM (``frontend_stub``
outside enc-dec) random patch embeddings with text M-RoPE positions; for
the encoder-decoder tokens and random frame embeddings of the prompt's
length for the encoder. Decode steps feed the reference's inputs, faults
and all: the VLM's step embeds its token and rotates it at M-RoPE
position 0 whatever its place (ROADMAP C5), and the encoder-decoder's
step passes tokens only, so its decoder skips cross-attention (ROADMAP
C6).

Prefill writes the prompt into the cache and attends through the plain
core with the cache's valid length (or, for RecurrentGemma's windowed
layers, the ring cache's slot positions), as the reference does, so it
launches no ``flash_attention``; the kernel runs on the cache-less
full-sequence forward. A hybrid model's prefill runs each RG-LRU layer's
recurrence through ``linear_scan`` once (the state folded in as step 0);
its decode steps take the RG-LRU's single-step path and launch no kernel.
An encoder-decoder prefill runs the encoder and the cross-attention
(prompt and frames of one length) through the kernel, one launch each a
layer.

``main`` returns its numbers: prefill seconds, decode seconds and tokens
per second (the ``gen - 1`` decode steps' tokens over their time; the
reference divides ``gen`` steps' worth by the same time), the
``flash_attention`` launches of its prefill, and the ids.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.configs import get as get_arch
from repro_torch.configs.base import reduced as reduce_cfg
from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.launch import steps as STEPS
from repro_torch.models import transformer as T


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the decoder to its first N layers (default: "
                         "the config's depth), for a model whose weights "
                         "do not fit the card whole")
    ap.add_argument("--seed", type=int, default=0,
                    help="weights seed; the prompt uses seed + 1")
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
    params = T.init_params(cfg, seed=args.seed, device=device)
    cache = T.init_cache(cfg, args.batch, args.prompt_len + args.gen,
                         device=device)
    prefill = STEPS.make_prefill_step(cfg)
    decode = STEPS.make_serve_step(cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    B, P = args.batch, args.prompt_len
    dtype = params["embed"].dtype
    vlm = cfg.frontend_stub and cfg.family != "enc_dec"
    if vlm:
        batch = {"embeds": torch.randn((B, P, cfg.d_model), generator=gen,
                                       device=device).to(dtype),
                 "positions": torch.arange(P, dtype=torch.int32,
                                           device=device)[None, :, None]
                 .expand(B, P, 3)}
    else:
        batch = {"tokens": torch.randint(0, cfg.vocab, (B, P), generator=gen,
                                         device=device)}
        if cfg.family == "enc_dec":
            batch["enc_embeds"] = torch.randn(
                (B, P, cfg.d_model), generator=gen, device=device).to(dtype)

    _sync(device)
    launched = flash_attention.launches
    t0 = time.perf_counter()
    logits_last, cache = prefill(params, cache, batch)
    tok = logits_last.float().argmax(dim=-1)[:, None]
    _sync(device)
    t1 = time.perf_counter()
    prefill_launches = flash_attention.launches - launched
    outs = [tok]
    for _ in range(args.gen - 1):
        if vlm:
            # The reference's step: M-RoPE positions of 0 at every step,
            # not prompt_len + t (ROADMAP C5).
            step_in = {"embeds": params["embed"][tok].to(dtype),
                       "positions": torch.zeros((B, 1, 3), dtype=torch.int32,
                                                device=device)}
        else:
            # Tokens only: an encoder-decoder step passes no enc_embeds,
            # so its decoder skips cross-attention (ROADMAP C6).
            step_in = {"tokens": tok}
        nxt, cache = decode(params, cache, step_in)
        tok = nxt[:, None]
        outs.append(tok)
    toks = torch.cat(outs, dim=1)
    _sync(device)
    dt = time.perf_counter() - t1
    steps = args.gen - 1
    result = {"arch": cfg.name, "reduced": args.reduced,
              "n_layers": cfg.n_layers,
              "device": str(device), "batch": args.batch,
              "prompt_len": args.prompt_len, "gen": args.gen,
              "prefill_s": t1 - t0, "decode_s": dt,
              "decode_tok_s": steps * args.batch / dt if steps else None,
              "prefill_flash_attention_launches": prefill_launches,
              "ids": toks.cpu().tolist()}
    print(f"[serve] {cfg.name}: prefill {args.prompt_len} tok x "
          f"{args.batch} in {t1 - t0:.3f}s; decoded {steps} steps x "
          f"{args.batch} seqs in {dt:.3f}s")
    print("[serve] sample token ids:", result["ids"][0][:8])
    return result


if __name__ == "__main__":
    print(json.dumps({k: v for k, v in main().items() if k != "ids"}))
