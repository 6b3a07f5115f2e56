"""End-to-end Demeter profiling CLI on PyTorch/CUDA.

    python -m repro_torch.launch.profile_run --ref ref.fasta --sample reads.fastq
    python -m repro_torch.launch.profile_run --synthetic --backend cuda_matmul

Counterpart of :mod:`repro.launch.profile_run`, with the same flags,
output lines and ``--json`` artifact, plus ``--device`` (default
``cuda``; without a GPU the run is a CLI error unless ``--device cpu``).
One :class:`~repro_torch.pipeline.config.ProfilerConfig` (step 1 from
flags) drives a :class:`~repro_torch.pipeline.session.ProfilingSession`:
RefDB build or load (step 2, cached under the same content key as
``repro``'s, so either package's cache entry serves the other), streamed
read conversion + classification (steps 3-4), abundance (step 5).

``--shards`` / ``--mesh`` (the ``sharded`` backend) and
``--noise-aware-refdb`` need modules that are not ported yet; they are CLI
errors that name the ROADMAP item, never a silent fallback.
"""

from __future__ import annotations

import argparse
import pathlib
import time

from repro_torch.core.hd_space import HDSpace
from repro_torch.eval import score_profile
from repro_torch.genomics import fasta, synth
from repro_torch.pipeline import (ArraySource, FastqSource, ProfilerConfig,
                                  ProfilingSession, ReadSource,
                                  available_backends, options_schema,
                                  resolve_backend)
from repro_torch.pipeline.backend import Backend
from repro_torch.pipeline.options import OptionError


def profile(genomes: dict, source: ReadSource | tuple, *,
            config: ProfilerConfig, backend: Backend | None = None,
            cache_dir: str | None = None, json_path: str | None = None):
    """Build-or-load the RefDB for ``config`` and profile ``source``.

    ``backend`` is a pre-resolved backend, whose device the run uses;
    without one the session resolves ``config.backend`` on ``cuda``.
    """
    session = ProfilingSession(config, backend=backend)

    t0 = time.perf_counter()
    db = session.build_or_load_refdb(genomes, cache_dir=cache_dir)
    t_build = time.perf_counter() - t0
    if session.refdb_loaded_from_cache:
        print(f"loaded HD-RefDB from {session.refdb_cache_file}")

    t0 = time.perf_counter()
    rep = session.profile(source)
    t_query = time.perf_counter() - t0

    print(f"\nbackend {config.backend} | build {t_build:.2f}s | "
          f"query {t_query:.2f}s "
          f"({rep.total_reads / max(t_query, 1e-9):.0f} reads/s) | "
          f"AM {db.memory_bytes() / 1e6:.2f} MB "
          f"({db.num_prototypes} prototypes)")
    print(f"reads: {rep.total_reads}  unmapped: {rep.unmapped_reads}  "
          f"multi: {rep.multi_reads}")
    print("\nspecies-level abundance (step 5):")
    for name, ab in rep.top(12):
        if ab > 0.001:
            print(f"  {name:24s} {100 * ab:6.2f}%")
    if json_path is not None:
        # The same machine-readable artifact as repro's CLI: one
        # ProfileReport JSON.
        p = pathlib.Path(json_path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(rep.to_json(indent=2))
        print(f"\nwrote report JSON to {p}")
    return rep


def _parse_spec(spec: str) -> tuple[str, str]:
    """Split ``KEY=VALUE`` (values stay raw; the schema types them)."""
    key, sep, raw = spec.partition("=")
    if not sep or not key:
        raise SystemExit(f"--backend-option expects KEY=VALUE, got {spec!r}")
    return key, raw


def _typed_options(ap, backend: str, pairs: list[tuple[str, str]]) -> dict:
    """Coerce raw ``--backend-option`` values through ``backend``'s declared
    schema: unknown keys and values that do not parse as the declared kind
    are CLI errors naming the option, identical across every backend."""
    schema = options_schema(backend)
    out = {}
    for key, raw in pairs:
        try:
            out[key] = schema.parse_cli(key, raw)
        except OptionError as e:
            ap.error(f"--backend-option: {e}")
    return out


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ref", help="reference FASTA")
    ap.add_argument("--sample", help="sample FASTQ")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--dim", type=int, default=8192)
    ap.add_argument("--ngram", type=int, default=16)
    ap.add_argument("--z-threshold", type=float, default=5.0)
    ap.add_argument("--window", type=int, default=4096)
    ap.add_argument("--stride", type=int, default=None,
                    help="window stride (default: non-overlapping)")
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--read-len", type=int, default=150)
    ap.add_argument("--cache-dir", default=None)
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write the ProfileReport as JSON")
    ap.add_argument("--backend", default="reference",
                    help="execution backend, one of the registered names "
                         "(see --list-backends; the cuda_* backends run "
                         "the CUDA kernels on a GPU and their plain torch "
                         "versions with --device cpu)")
    ap.add_argument("--backend-option", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="backend-specific option, repeatable (e.g. "
                         "--backend cuda_fused --backend-option bb=32)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; cpu runs "
                         "the plain torch path on the host)")
    ap.add_argument("--mesh", type=int, default=None, metavar="N",
                    help="size of the profiling mesh (needs the sharded "
                         "backend: not ported yet, ROADMAP queue 1 item 7)")
    ap.add_argument("--shards", type=int, default=None, metavar="N",
                    help="shard the RefDB prototype axis N ways (not "
                         "ported yet, ROADMAP queue 1 item 7)")
    ap.add_argument("--list-backends", action="store_true",
                    help="print the registered backend names with their "
                         "declared options and exit")
    ap.add_argument("--noise-aware-refdb", action="store_true",
                    help="retrain the RefDB prototypes on simulated noisy "
                         "readout (not ported yet, ROADMAP queue 1 item 10)")
    ap.add_argument("--noise-aware-iters", type=int, default=2,
                    help="retraining passes for --noise-aware-refdb")
    return ap


def main(argv: list[str] | None = None) -> None:
    ap = _parser()
    args = ap.parse_args(argv)

    if args.list_backends:
        for name in available_backends():
            print(name)
            for row in options_schema(name).describe():
                print(f"  {row}")
        return
    if args.shards is not None or args.mesh is not None:
        ap.error("--shards/--mesh need the sharded backend, which is not "
                 "ported to repro_torch yet (ROADMAP queue 1 item 7)")
    if args.noise_aware_refdb:
        ap.error("--noise-aware-refdb needs the device model and the "
                 "noise-aware RefDB build, which are not ported to "
                 "repro_torch yet (ROADMAP queue 1 item 10)")
    if args.backend not in available_backends():
        ap.error(f"unknown backend {args.backend!r}; available: "
                 f"{', '.join(available_backends())}")

    options = _typed_options(
        ap, args.backend, [_parse_spec(s) for s in args.backend_option])
    config = ProfilerConfig(
        space=HDSpace(dim=args.dim, ngram=args.ngram,
                      z_threshold=args.z_threshold),
        window=args.window, stride=args.stride,
        batch_size=args.batch_size, backend=args.backend,
        backend_options=options,
        noise_aware_iters=args.noise_aware_iters)
    try:    # bad options and a missing GPU are CLI errors, not tracebacks
        backend = resolve_backend(config.backend, config, device=args.device)
    except (ValueError, RuntimeError) as e:
        ap.error(str(e))

    if args.synthetic or not args.ref:
        spec = synth.CommunitySpec(num_species=10, genome_len=60_000)
        genomes, toks, lens, truth, true_ab = synth.make_sample(
            spec, num_reads=2_000)
        rep = profile(genomes, ArraySource(toks, lens), config=config,
                      backend=backend, cache_dir=args.cache_dir,
                      json_path=args.json)
        m = score_profile(rep.abundance, true_ab)
        print(f"\nvs ground truth: {m.row()}")
        return
    genomes = fasta.read_fasta(args.ref)
    profile(genomes, FastqSource(args.sample, args.read_len),
            config=config, backend=backend, cache_dir=args.cache_dir,
            json_path=args.json)


if __name__ == "__main__":
    main()
