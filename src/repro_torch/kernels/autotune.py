"""Tile autotuner for the fused encode->search kernel on Hopper.

Counterpart of :mod:`repro.kernels.autotune`, re-derived for the CUDA
kernel (:mod:`repro_torch.kernels.fused_profile`).  The kernel's tiling
has two knobs: ``bb`` (reads a cluster tile, :data:`BATCH_TILES`) and
``cluster`` (blocks a cluster sharing one encoded tile,
:data:`CLUSTER_SIZES`).  The tuner keeps the candidates that fit the card
-- shared memory per block (:func:`fused_profile.smem_bytes`) within the
227 KB a block may use (:data:`fused_profile.MAX_SMEM_BYTES`), and, on a
card, at least one cluster resident at once
(``fused_profile_max_active_clusters`` > 0) -- times each with CUDA
events on synthetic inputs made from a seed at the live shape, and keeps
the fastest in an on-disk JSON cache, so every later session, service or
process with the same key reuses it without measuring.

**Read length.**  The kernel's shared memory grows with the read length
(it stages each read's tokens and pair ids), so a tiling that fits
150-token reads may not fit a service cohort padded to 2,048: at
D = 40,960 and n = 16, ``bb`` 32 / ``cluster`` 2 needs 224 KB at
L = 256 and 250 KB at L = 2,048.  ``repro``'s cache key has no read
length.  This one does: the key carries the read-length *bucket* (the
power of two at or above the read length, at least 16 -- the service's
default cohort widths), and the candidates are filtered at the bucket's
length, so a pick is feasible for every read length of its bucket.  A
cached pick that does not fit its bucket is measured again.  Each new
bucket a session sees is tuned (or read from the cache) at its first
batch.

**Alphabet.**  Above 4 symbols the kernel's wide path keeps 2A table
rows of the block's words in shared memory where they fit beside the
tile, and reads them through L2 where they do not (at A = 20, bb 16 /
cluster 1 would need 306 KB with them).  So a tiling's shared memory is
counted with its tables where they fit and without them where they do
not, and the key carries the alphabet above 4: the place of the tables
moves the times.

Wired into the pipeline as ``backend_options autotune=true`` on
``cuda_fused`` (:mod:`repro_torch.pipeline.fused`); also usable alone::

    PYTHONPATH=src python -m repro_torch.kernels.autotune --smoke

Cache location: ``~/.cache/repro_torch/autotune.json``, overridable with
the ``REPRO_TORCH_AUTOTUNE_CACHE`` environment variable or an explicit
``path=`` argument -- never ``repro``'s file, whose tiles mean something
else.  The key also names the platform and the card, so a cache shared
by machines keeps their picks apart.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.core import item_memory
from repro_torch.core.hd_space import HDSpace
from repro_torch.device import resolve_device
from repro_torch.kernels import fused_profile

#: Default on-disk cache (see module docstring for overrides).
DEFAULT_CACHE = Path("~/.cache/repro_torch/autotune.json")
ENV_VAR = "REPRO_TORCH_AUTOTUNE_CACHE"
#: Shortest read-length bucket (the service's shortest default cohort).
MIN_BUCKET = 16


def cache_path(path: str | os.PathLike | None = None) -> Path:
    """Resolve the cache file: explicit arg > env override > default."""
    if path is not None:
        return Path(path)
    env = os.environ.get(ENV_VAR)
    return Path(env) if env else DEFAULT_CACHE.expanduser()


def read_len_bucket(read_len: int) -> int:
    """The power of two at or above ``read_len`` (at least 16)."""
    b = MIN_BUCKET
    while b < read_len:
        b *= 2
    return b


def cache_key(b: int, w: int, s: int, dim: int, read_len: int,
              device: str | torch.device | None = None, *,
              alphabet: int = fused_profile.NARROW_ALPHABET) -> str:
    """Cache key: (platform, card, B, W, S, dim, read-length bucket) and,
    above 4 symbols, the alphabet (the wide path's tables change what
    fits and how fast)."""
    dev = resolve_device(device)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    wide = (f"|A{alphabet}" if alphabet > fused_profile.NARROW_ALPHABET
            else "")
    return (f"{dev.type}|{kind}|B{b}|W{w}|S{s}|D{dim}"
            f"|L{read_len_bucket(read_len)}{wide}")


def load_cache(path: str | os.PathLike | None = None) -> dict:
    """Read the cache; missing or corrupt files are an empty cache."""
    try:
        data = json.loads(cache_path(path).read_text())
    except (OSError, ValueError):
        return {}
    return data if isinstance(data, dict) else {}


def save_cache(cache: dict, path: str | os.PathLike | None = None) -> Path:
    """Atomically write the cache (temp file + rename, crash-safe)."""
    p = cache_path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=p.parent, prefix=p.name + ".")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(cache, f, indent=2, sort_keys=True)
        os.replace(tmp, p)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return p


def candidate_tiles() -> list[dict[str, int]]:
    """Every tiling the kernel takes: ``bb`` x ``cluster``."""
    return [{"bb": bb, "cluster": cl} for bb in fused_profile.BATCH_TILES
            for cl in fused_profile.CLUSTER_SIZES]


def fits(tiles: dict[str, int], space: HDSpace, read_len: int,
         device: torch.device) -> bool:
    """Whether the kernel can launch ``tiles`` for reads of ``read_len``
    tokens: shared memory within the block limit and, on a card, at
    least one cluster resident at once."""
    args = (tiles["bb"], tiles["cluster"], read_len, space.ngram,
            space.alphabet_size, space.num_words)
    if fused_profile.smem_bytes(*args, fused_profile.shared_tables(*args)) \
            > fused_profile.MAX_SMEM_BYTES:
        return False
    if device.type != "cuda":
        return True
    return fused_profile.max_active_clusters(
        tiles["bb"], tiles["cluster"], read_len, space.ngram,
        space.num_words, space.alphabet_size) > 0


def feasible_tiles(space: HDSpace, read_len: int,
                   device: str | torch.device | None = None
                   ) -> list[dict[str, int]]:
    """The candidates that fit every read of ``read_len``'s bucket."""
    dev = resolve_device(device)
    bucket = read_len_bucket(read_len)
    return [t for t in candidate_tiles() if fits(t, space, bucket, dev)]


def _synthetic_inputs(space: HDSpace, batch: int, num_prototypes: int,
                      read_len: int, seed: int, device: torch.device,
                      partitionable: bool = True):
    """Measurement inputs at the live shape, made from ``seed``, in the
    form the kernel wrapper takes (with the rolled item memory drawn in
    the session's threefry mode)."""
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(
        0, space.alphabet_size, (batch, read_len), dtype=np.int32)).to(device)
    lengths = torch.full((batch,), read_len, dtype=torch.int32, device=device)
    im = item_memory.make_item_memory(space, device=device,
                                      partitionable=partitionable)
    tie = item_memory.make_tie_break(space, device=device,
                                     partitionable=partitionable)
    protos = torch.from_numpy(rng.integers(
        0, 2 ** 32, (num_prototypes, space.num_words), dtype=np.uint32
    ).view(np.int32)).to(device)
    return (tokens, lengths,
            item_memory.rolled(im, space.ngram).contiguous(), tie, protos)


def _time_tiles(tiles: dict[str, int], args, space: HDSpace,
                reps: int) -> float:
    """Mean seconds a launch of the kernel alone over ``reps``
    back-to-back launches after one warm-up: CUDA events on a card, the
    host clock on the CPU."""
    tokens, lengths, im_rolled, tie, protos = args

    def run():
        return fused_profile.fused_profile(tokens, lengths, im_rolled, tie,
                                           protos, dim=space.dim, **tiles)

    reps = max(1, reps)
    run()
    if tokens.device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        return (time.perf_counter() - t0) / reps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(tokens.device)
    start.record()
    for _ in range(reps):
        run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / reps


def tune(space: HDSpace, *, batch: int, num_prototypes: int, read_len: int,
         path: str | os.PathLike | None = None, force: bool = False,
         trials: int = 10, seed: int = 0,
         device: str | torch.device | None = None,
         partitionable: bool = True) -> tuple[dict[str, int], bool]:
    """Pick (and cache) the fastest tiling that fits the live shape.

    Returns ``(tiles, cached)``: ``tiles`` is ``{"bb", "cluster"}`` and
    ``cached`` is True when it came straight from the cache (no
    measurement ran).  ``trials`` is the launches timed per candidate;
    ``partitionable`` is the session's threefry mode, in which the
    measurement's item memory is drawn.

    Raises:
      ValueError: no tiling fits reads of ``read_len``'s bucket.
    """
    dev = resolve_device(device)
    key = cache_key(batch, space.num_words, num_prototypes, space.dim,
                    read_len, dev, alphabet=space.alphabet_size)
    bucket = read_len_bucket(read_len)
    cache = load_cache(path)
    entry = cache.get(key)
    if entry is not None and not force:
        try:
            tiles = {k: int(entry["tiles"][k]) for k in ("bb", "cluster")}
        except (KeyError, TypeError, ValueError):
            tiles = None                       # malformed entry: a miss
        if tiles is not None and tiles in candidate_tiles() \
                and fits(tiles, space, bucket, dev):
            return tiles, True

    feasible = feasible_tiles(space, read_len, dev)
    if not feasible:
        raise ValueError(
            f"autotune: no fused_profile tiling fits reads of up to "
            f"{bucket} tokens at W={space.num_words}, n={space.ngram} "
            f"(shared memory above {fused_profile.MAX_SMEM_BYTES} bytes a "
            f"block); use an unfused backend for reads this long")
    args = _synthetic_inputs(space, batch, num_prototypes, read_len, seed,
                             dev, partitionable)
    timed = [(_time_tiles(t, args, space, trials), t) for t in feasible]
    best_t, best = min(timed, key=lambda tt: tt[0])
    cache[key] = {
        "tiles": best,
        "time_s": best_t,
        "swept": len(feasible),
        "times_s": {f"bb{t['bb']}/cluster{t['cluster']}": s
                    for s, t in timed},
        "smem_bytes": fused_profile.check_tiles(
            best["bb"], best["cluster"], bucket, space.ngram,
            space.alphabet_size, space.num_words),
        "read_len_bucket": bucket,
    }
    save_cache(cache, path)
    return dict(best), False


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="Time every fused-kernel tiling that fits and cache "
                    "the fastest.")
    ap.add_argument("--smoke", action="store_true",
                    help="tune a small shape (dim=512, B=64, S=44, L=1024) "
                         "instead of a custom one")
    ap.add_argument("--dim", type=int, default=40_960)
    ap.add_argument("--ngram", type=int, default=16)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--prototypes", type=int, default=9_780)
    ap.add_argument("--read-len", type=int, default=150)
    ap.add_argument("--trials", type=int, default=10)
    ap.add_argument("--force", action="store_true",
                    help="re-measure even on a cache hit")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain version: every "
                         "tiling runs the same code, so the pick means "
                         "nothing there)")
    ap.add_argument("--out", default=None,
                    help=f"cache file (default: {ENV_VAR} or "
                         f"{DEFAULT_CACHE})")
    args = ap.parse_args(argv)

    if args.smoke:
        space = HDSpace(dim=512, ngram=8, z_threshold=3.0)
        batch, protos, read_len = 64, 44, 1024
    else:
        space = HDSpace(dim=args.dim, ngram=args.ngram)
        batch, protos, read_len = args.batch, args.prototypes, args.read_len
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))
    tiles, cached = tune(space, batch=batch, num_prototypes=protos,
                         read_len=read_len, path=args.out, force=args.force,
                         trials=args.trials, device=dev)
    key = cache_key(batch, space.num_words, protos, space.dim, read_len, dev)
    print(json.dumps({
        "key": key,
        "tiles": tiles,
        "cached": cached,
        "cache": str(cache_path(args.out)),
        "entry": load_cache(args.out).get(key),
    }, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
