"""Batched LM serving driver: one cohort through prefill and decode.

Counterpart of :mod:`repro.launch.serve`, with ``repro``'s flags, on the
card unless ``--device cpu``:

    python -m repro_torch.launch.serve --arch stablelm-3b --requests 8 --steps 16
    python -m repro_torch.launch.serve --arch stablelm-3b --full   # 2.8 B params

The model is ``repro``'s ``init_lm(jax.random.key(0), cfg)`` drawn
through the port's Threefry (the kernel on the card), the prompts
``np.random.default_rng(0)``'s, and sampling takes ``jax.random.key(1)``
and its splits, so a run serves the tokens ``repro``'s serves.  The
cohort prefills once and decodes in lockstep; the decode cache is
written in place.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import threefry
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.serve import serve_step


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(arch: str, *, num_requests: int, decode_steps: int,
          prompt_len: int = 32, smoke: bool = True,
          temperature: float = 0.0,
          device: str | torch.device | None = None,
          partitionable: bool = threefry.PARTITIONABLE) -> dict:
    """Serve ``num_requests`` random prompts of ``prompt_len`` tokens for
    ``decode_steps`` steps.  Returns ``prefill_s``, ``decode_s``,
    ``tokens`` (``(B, decode_steps + 1)`` numpy) and ``num_params``."""
    dev = resolve_device(device)
    cfg = get_config(arch, smoke=smoke)
    if cfg.is_encdec:
        raise ValueError(f"{arch}: an enc-dec model needs encoder frames, "
                         "which this driver does not make")
    with torch.inference_mode():
        params = lm.init_lm(0, cfg, device=dev, partitionable=partitionable)
        rng = np.random.default_rng(0)
        max_len = prompt_len + decode_steps + 1

        prefill = serve_step.make_prefill_step(
            cfg, max_len, q_chunk=min(512, prompt_len),
            kv_chunk=min(512, prompt_len))
        decode = serve_step.make_decode_step(cfg)

        prompts = torch.from_numpy(
            rng.integers(0, cfg.vocab, (num_requests, prompt_len)).astype(
                np.int32)).to(dev)
        _sync(dev)
        t0 = time.perf_counter()
        logits, caches = prefill(params, prompts)
        _sync(dev)
        t_prefill = time.perf_counter() - t0

        key = threefry.key(1)
        tok = serve_step.sample(logits, key, temperature,
                                partitionable=partitionable)
        outs = [tok]
        t0 = time.perf_counter()
        for i in range(decode_steps):
            logits, caches = decode(params, tok, caches, prompt_len + i)
            key, sub = threefry.split(key, 2, partitionable=partitionable)
            tok = serve_step.sample(logits, sub, temperature,
                                    partitionable=partitionable)
            outs.append(tok)
        _sync(dev)
        t_decode = time.perf_counter() - t0

    toks_per_s = num_requests * decode_steps / max(t_decode, 1e-9)
    print(f"cohort={num_requests} prefill {t_prefill * 1e3:.0f}ms | "
          f"decode {decode_steps} steps {t_decode * 1e3:.0f}ms "
          f"({toks_per_s:.0f} tok/s)")
    out = {"prefill_s": t_prefill, "decode_s": t_decode,
           "tokens": torch.stack(outs, dim=1).cpu().numpy(),
           "num_params": sum(p.numel() for p in params.parameters())}
    return out


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain path on the host)")
    ap.add_argument("--no-threefry-partitionable", dest="partitionable",
                    action="store_false",
                    help="draw the weights and samples as jax < 0.5 does "
                         "(jax_threefry_partitionable=False)")
    args = ap.parse_args(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))
    serve(args.arch, num_requests=args.requests, decode_steps=args.steps,
          prompt_len=args.prompt_len, smoke=not args.full,
          temperature=args.temperature, device=args.device,
          partitionable=args.partitionable)


if __name__ == "__main__":
    main()
