"""End-to-end Demeter profiling CLI on PyTorch/CUDA.

    python -m repro_torch.launch.profile_run --ref ref.fasta --sample reads.fastq
    python -m repro_torch.launch.profile_run --synthetic --backend cuda_matmul

Counterpart of :mod:`repro.launch.profile_run`, with the same flags,
output lines and ``--json`` artifact, plus ``--device`` (default
``cuda``; without a GPU the run is a CLI error unless ``--device cpu``).
``--no-threefry-partitionable`` sets the config's threefry mode to jax's
pre-0.5 one, which a RefDB ``repro`` built under jax 0.4 needs.
One :class:`~repro_torch.pipeline.config.ProfilerConfig` (step 1 from
flags) drives a :class:`~repro_torch.pipeline.session.ProfilingSession`:
RefDB build or load (step 2, cached under the same content key as
``repro``'s, so either package's cache entry serves the other), streamed
read conversion + classification (steps 3-4), abundance (step 5).

``--shards N`` / ``--mesh N`` wrap the chosen backend in ``sharded``
(the prototype axis split N ways, one rank a shard), with ``repro``'s
conflict checks.  Run N ranks with torchrun::

    torchrun --nproc-per-node 2 -m repro_torch.launch.profile_run \
        --synthetic --shards 2

Every rank profiles the same reads; rank 0 prints the report and the
``sharded N ways (... base): .. MB per device`` line.
``--noise-aware-refdb`` retrains the RefDB on simulated noisy readout
through the chosen backend (``pcm_sim`` / ``racetrack_sim`` with their
``--backend-option`` device knobs), as ``repro``'s CLI does; the refined
database joins the cache key, and its manifest records ``noise_aware``.
"""

from __future__ import annotations

import argparse
import pathlib
import time

import torch.distributed as dist

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
    say = _rank0_print(session)

    t0 = time.perf_counter()
    db = session.build_or_load_refdb(genomes, cache_dir=cache_dir)
    t_build = time.perf_counter() - t0
    if session.refdb_loaded_from_cache:
        say(f"loaded HD-RefDB from {session.refdb_cache_file}")

    t0 = time.perf_counter()
    rep = session.profile(source)
    t_query = time.perf_counter() - t0

    # A sharded session holds this rank's rows; the AM line counts all.
    shards = getattr(session.backend, "num_shards", 1)
    rows = db.num_prototypes * shards
    am_bytes = (db.prototypes.numel() + db.proto_species.numel()) * 4 \
        * shards + db.genome_lengths.numel() * 4
    say(f"\nbackend {config.backend} | build {t_build:.2f}s | "
        f"query {t_query:.2f}s "
        f"({rep.total_reads / max(t_query, 1e-9):.0f} reads/s) | "
        f"AM {am_bytes / 1e6:.2f} MB ({rows} prototypes)")
    if shards > 1:
        say(f"sharded {shards} ways ({session.backend.base.name} base): "
            f"{db.memory_bytes() / 1e6:.2f} MB per device")
    say(f"reads: {rep.total_reads}  unmapped: {rep.unmapped_reads}  "
        f"multi: {rep.multi_reads}")
    say("\nspecies-level abundance (step 5):")
    for name, ab in rep.top(12):
        if ab > 0.001:
            say(f"  {name:24s} {100 * ab:6.2f}%")
    if json_path is not None and say is print:
        # The same machine-readable artifact as repro's CLI: one
        # ProfileReport JSON.
        p = pathlib.Path(json_path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(rep.to_json(indent=2))
        say(f"\nwrote report JSON to {p}")
    return rep


def _rank0_print(session: ProfilingSession):
    """``print`` on rank 0 of a sharded session (and on any unsharded
    one); a no-op on the other ranks, which profile the same reads."""
    mesh = getattr(session.backend, "mesh", None)
    if mesh is None or mesh.rank == 0:
        return print
    return lambda *args, **kwargs: None


def _parse_spec(spec: str) -> tuple[str, str]:
    """Split ``KEY=VALUE`` (values stay raw; the schema types them)."""
    key, sep, raw = spec.partition("=")
    if not sep or not key:
        raise SystemExit(f"--backend-option expects KEY=VALUE, got {spec!r}")
    return key, raw


def _typed_options(ap, backend: str, pairs: list[tuple[str, str]]) -> dict:
    """Coerce raw ``--backend-option`` values through ``backend``'s declared
    schema: unknown keys and values that do not parse as the declared kind
    are CLI errors naming the option, identical across every backend.
    For a passthrough backend (``sharded``) unknown keys fall through to
    the wrapped base's schema."""
    schema = options_schema(backend)
    base_schema = None
    if schema.passthrough:
        base = dict(pairs).get("base", "reference")
        if base in available_backends():
            base_schema = options_schema(base)
    out = {}
    for key, raw in pairs:
        use = schema
        if (schema.option(key) is None and schema.passthrough
                and base_schema is not None):
            use = base_schema
        try:
            out[key] = use.parse_cli(key, raw)
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
                         "--backend cuda_fused --backend-option bb=32, or "
                         "--backend pcm_sim --backend-option preset=pcm)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; cpu runs "
                         "the plain torch path on the host)")
    ap.add_argument("--no-threefry-partitionable", dest="partitionable",
                    action="store_false",
                    help="draw the item memory in jax's pre-0.5 threefry "
                         "mode (jax_threefry_partitionable=False), as a "
                         "repro run under jax 0.4 does")
    ap.add_argument("--mesh", type=int, default=None, metavar="N",
                    help="size of the 1-D ('shard',) profiling mesh. One "
                         "shard lives on each rank, so this and --shards "
                         "are the same knob (given both, they must agree); "
                         "start N ranks with torchrun --nproc-per-node N")
    ap.add_argument("--shards", type=int, default=None, metavar="N",
                    help="shard the RefDB prototype axis N ways: wraps the "
                         "chosen backend in the 'sharded' backend (reports "
                         "stay bit-identical; each rank holds 1/N of the "
                         "database)")
    ap.add_argument("--list-backends", action="store_true",
                    help="print the registered backend names with their "
                         "declared options and exit")
    ap.add_argument("--noise-aware-refdb", action="store_true",
                    help="retrain the RefDB prototypes on simulated noisy "
                         "readout through the chosen backend (the "
                         "margin-maximizing co-design pass; joins the "
                         "RefDB cache key)")
    ap.add_argument("--noise-aware-iters", type=int, default=2,
                    help="retraining passes for --noise-aware-refdb")
    return ap


def main(argv: list[str] | None = None) -> None:
    ap = _parser()
    args = ap.parse_args(argv)

    if args.list_backends:
        for name in available_backends():
            print(name)
            schema = options_schema(name)
            for row in schema.describe():
                print(f"  {row}")
            if schema.passthrough:
                print("  (+ the wrapped base backend's options, validated "
                      "by its own schema)")
        return
    if args.backend not in available_backends():
        ap.error(f"unknown backend {args.backend!r}; available: "
                 f"{', '.join(available_backends())}")

    backend, options = _sharding(ap, args, [_parse_spec(s)
                                            for s in args.backend_option])
    config = ProfilerConfig(
        space=HDSpace(dim=args.dim, ngram=args.ngram,
                      z_threshold=args.z_threshold),
        window=args.window, stride=args.stride,
        batch_size=args.batch_size, backend=backend,
        backend_options=options,
        noise_aware_refdb=args.noise_aware_refdb,
        noise_aware_iters=args.noise_aware_iters,
        threefry_partitionable=args.partitionable)
    # A process group the sharded backend makes here is torn down at the
    # end; one the caller made is left alone.
    own_group = not (dist.is_available() and dist.is_initialized())
    try:    # bad options and a missing GPU are CLI errors, not tracebacks
        backend = resolve_backend(config.backend, config, device=args.device)
    except (ValueError, RuntimeError) as e:
        ap.error(str(e))

    try:
        if args.synthetic or not args.ref:
            spec = synth.CommunitySpec(num_species=10, genome_len=60_000)
            genomes, toks, lens, truth, true_ab = synth.make_sample(
                spec, num_reads=2_000)
            rep = profile(genomes, ArraySource(toks, lens), config=config,
                          backend=backend, cache_dir=args.cache_dir,
                          json_path=args.json)
            if getattr(getattr(backend, "mesh", None), "rank", 0) == 0:
                m = score_profile(rep.abundance, true_ab)
                print(f"\nvs ground truth: {m.row()}")
            return
        genomes = fasta.read_fasta(args.ref)
        profile(genomes, FastqSource(args.sample, args.read_len),
                config=config, backend=backend, cache_dir=args.cache_dir,
                json_path=args.json)
    finally:
        if own_group and dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()


def _sharding(ap, args, pairs: list[tuple[str, str]]
              ) -> tuple[str, dict]:
    """The effective backend and typed options, with ``--shards`` /
    ``--mesh`` folded in as ``repro``'s CLI does: the options ride into
    ``sharded`` (whose passthrough forwards base-backend knobs), and a
    flag that disagrees with another flag or with an option is an error,
    never a quiet winner."""
    wrapping = ((args.shards is not None or args.mesh is not None)
                and args.backend != "sharded")
    base_hint = ([("base", args.backend)]
                 if wrapping and "base" not in dict(pairs) else [])
    options = _typed_options(
        ap, "sharded" if wrapping else args.backend, pairs + base_hint)
    if base_hint:       # parse-time hint only; the wrap below re-adds it
        del options["base"]
    backend = args.backend
    if args.mesh is not None and args.shards is not None \
            and args.mesh != args.shards:
        ap.error(f"--mesh {args.mesh} conflicts with --shards "
                 f"{args.shards}: the mesh holds one shard per rank, "
                 f"so the two must agree (or give just one)")
    shards = args.shards if args.shards is not None else args.mesh
    if shards is not None:
        if "shards" in options and options["shards"] != shards:
            ap.error(f"--shards {shards} conflicts with "
                     f"--backend-option shards={options['shards']}")
        if backend != "sharded":
            if "base" in options and options["base"] != backend:
                ap.error(f"--backend {backend} conflicts with "
                         f"--backend-option base={options['base']}")
            # --shards N means "this backend, N ways": the sharded backend
            # wraps it as its base, same reports, 1/N database per rank.
            options = {**options, "base": backend, "shards": shards}
            backend = "sharded"
        else:
            options["shards"] = shards
    return backend, options


if __name__ == "__main__":
    main()
