#!/usr/bin/env python3
"""The LM decode step's attention, two forms side by side on one card.

    python3 tools/decode_attention_ab.py

``upcast`` is the form ``models/blocks.cached_attention`` had first: it
casts the layer's K to float32 for the score product, then runs both
products as ``einsum``s.  ``cached_attention`` is the port's form: two
``bmm``s over views of the cache (scores in float32 from bf16 operands,
``q`` block-diagonal), no copy of K or V.  Prints, with the card's name
and power limit on every line:

* ``parts``: the port's form taken apart at bf16 caches of 8 x 545,
  8 x 32,768, 1 x 32,768 and 32 x 8,192 positions (32 heads of 80, as
  stablelm-3b): ms of the block-diagonal ``q``, the score product, the
  softmax over the last axis (as the port runs it) and over the middle
  one, the output product; and the ``bytes`` bound (K and V read once at
  3.35 TB/s).
* ``form``: both forms at 8 x 545, 8 x 32,768 and 1 x 32,768: ms a call
  (CUDA events, 20 calls), bytes allocated beside the cache, and their
  largest difference.
* ``serve``: ``launch.serve.serve("stablelm-3b", smoke=False)``, 8
  requests, at 512 prompt tokens and 32 decode steps and at 4,096 and 16,
  with one form and then the other in the order upcast, port, port,
  upcast, upcast, port: prefill ms, decode ms and tok/s, peak memory.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEG_INF = -1e30


def upcast(q, cache, cur_pos, window):
    """``cached_attention`` with a float32 copy of K (the first form)."""
    import torch

    k, v, kpos = cache["k"], cache["v"], cache["kpos"]
    b, s, kv, dh = k.shape
    g = q.shape[1] // kv
    qg = q.reshape(b, kv, g, q.shape[-1])
    logits = torch.einsum("bkgd,bskd->bkgs", qg.to(torch.float32),
                          k.to(torch.float32)) * q.shape[-1] ** -0.5
    valid = (kpos >= 0) & (kpos <= cur_pos)
    if window is not None:
        valid &= kpos > cur_pos - window
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bskv->bkgv", w.to(v.dtype), v)
    return out.reshape(b, q.shape[1], v.shape[-1])


def cuda_ms(fn, reps: int = 20) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch

    if not torch.cuda.is_available():
        print("decode_attention_ab: needs a CUDA GPU", file=sys.stderr)
        return 2
    from repro_torch.launch import serve as lm_serve
    from repro_torch.models import blocks

    card = os.popen("nvidia-smi --query-gpu=name,power.limit "
                    "--format=csv,noheader").read().strip()
    f32, bf16 = torch.float32, torch.bfloat16
    kv, dh, h = 32, 80, 32

    def cache_of(b, s):
        gen = torch.Generator(device="cuda").manual_seed(s)
        shape = (b, s, kv, dh)
        return ({"k": torch.randn(shape, generator=gen, device="cuda").to(bf16),
                 "v": torch.randn(shape, generator=gen, device="cuda").to(bf16),
                 "kpos": torch.arange(s, device="cuda", dtype=torch.int32
                                      ).expand(b, s)},
                torch.randn((b, h, dh), generator=gen, device="cuda").to(bf16))

    for b, s in ((8, 545), (8, 32_768), (1, 32_768), (32, 8_192)):
        cache, q = cache_of(b, s)
        heads = torch.arange(kv, device="cuda")

        def qblock():
            z = q.new_zeros((b, kv, kv, 1, dh))
            z[:, heads, heads] = q.reshape(b, kv, 1, dh)
            return z.permute(0, 1, 3, 2, 4).reshape(b, h, kv * dh)
        qb = qblock()
        kt = cache["k"].view(b, s, kv * dh).transpose(1, 2)
        vf = cache["v"].view(b, s, kv * dh)
        logits = torch.bmm(qb, kt, out_dtype=f32)
        w = torch.softmax(logits, -1).to(bf16)
        mid = logits.transpose(1, 2).contiguous()
        parts = {
            "q_block": cuda_ms(qblock),
            "scores": cuda_ms(lambda: torch.bmm(qb, kt, out_dtype=f32)),
            "softmax_last": cuda_ms(lambda: torch.softmax(logits, -1)),
            "softmax_middle": cuda_ms(lambda: torch.softmax(mid, 1)),
            "output": cuda_ms(lambda: torch.bmm(w, vf)),
        }
        bound = 2 * cache["k"].numel() * 2 / 3.35e12 * 1e3
        print(f"parts B={b} S={s}: bytes bound {bound:.3f} ms | "
              + " ".join(f"{n} {ms:.3f}" for n, ms in parts.items())
              + f" ms | {card}", flush=True)
        del cache, q, qb, kt, vf, logits, w, mid
        torch.cuda.empty_cache()

    for b, s in ((8, 545), (8, 32_768), (1, 32_768)):
        cache, q = cache_of(b, s)
        kv_mb = 2 * cache["k"].numel() * 2 / 1e6
        outs = {}
        for name, fn in (("upcast", upcast),
                         ("cached_attention", blocks.cached_attention)):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            outs[name] = fn(q, cache, s - 1, None).float()
            extra = (torch.cuda.max_memory_allocated() - base) / 1e6
            ms = cuda_ms(lambda: fn(q, cache, s - 1, None))
            print(f"form B={b} S={s} {name}: {ms:.4f} ms, {extra:.1f} MB "
                  f"allocated beside K + V {kv_mb:.1f} MB | {card}",
                  flush=True)
        gap = float((outs["upcast"] - outs["cached_attention"]).abs().max())
        print(f"form B={b} S={s}: largest difference {gap:.2e}", flush=True)
        del cache, q, outs
        torch.cuda.empty_cache()

    port = blocks.cached_attention
    try:
        for prompt, steps in ((512, 32), (4096, 16)):
            for name in ("upcast", "port", "port", "upcast", "upcast",
                         "port"):
                blocks.cached_attention = upcast if name == "upcast" \
                    else port
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                out = lm_serve.serve("stablelm-3b", smoke=False,
                                     num_requests=8, prompt_len=prompt,
                                     decode_steps=steps)
                print(f"serve prompt {prompt} steps {steps} {name}: "
                      f"prefill {out['prefill_s'] * 1e3:.1f} ms, decode "
                      f"{out['decode_s'] * 1e3:.1f} ms, "
                      f"{8 * steps / out['decode_s']:.1f} tok/s, peak "
                      f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB | "
                      f"{card}", flush=True)
    finally:
        blocks.cached_attention = port
    return 0


if __name__ == "__main__":
    sys.exit(main())
