"""The system under test, set up from a configuration file.

A configuration (``perfbench/configs/<name>.json``) states the deployment:
the HD space, the RefDB windowing, the batch, the backend and its options,
and the community (``num_species``, ``genome_len``,
``homology_fraction``, ``strain_snp_rate``, ``read_error_rate``).
:func:`setup` makes the community from the seed, builds the RefDB
through ``ProfilingSession.build_refdb`` and returns what the traffic
drivers and the correctness check need.  The program is the
PyTorch port, ``repro_torch``; nothing here imports the JAX package.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from perfbench import generator, paths


@dataclasses.dataclass
class System:
    config: dict
    session: object                 # repro_torch ProfilingSession
    genomes: np.ndarray             # (species, genome_len) uint8
    orgs: np.ndarray                # the strains the samples are drawn from
    names: tuple[str, ...]
    refdb_build_s: float
    timings: dict                   # set-up steps, seconds


def profiler_config(config: dict):
    from repro_torch.core.hd_space import HDSpace
    from repro_torch.pipeline.config import ProfilerConfig

    opts = dict(config.get("backend_options", {}))
    if opts.get("autotune"):
        # The tile picks persist inside the checkout, at a fixed path.
        opts["autotune_cache"] = str(paths.cache_dir() / "autotune.json")
    return ProfilerConfig(space=HDSpace(**config["space"]),
                          window=config["window"], stride=config["stride"],
                          batch_size=config["batch_size"],
                          backend=config["backend"], backend_options=opts)


def setup(config: dict, seed: int, device: str, *, metrics=None) -> System:
    """Make the community and build the RefDB (the cell's set-up)."""
    from repro_torch.pipeline.session import ProfilingSession

    t = {}
    t0 = time.perf_counter()
    c = config
    refs = generator.genomes(seed, c["num_species"], c["genome_len"],
                             c["homology_fraction"])
    orgs = generator.strains(seed, refs, c["strain_snp_rate"])
    names = tuple(f"species_{s:02d}" for s in range(c["num_species"]))
    t["community_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    session = ProfilingSession(profiler_config(config), device=device,
                               metrics=metrics)
    t["session_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    session.build_refdb(dict(zip(names, refs)))
    if session.device.type == "cuda":
        torch.cuda.synchronize(session.device)
    build = time.perf_counter() - t0
    t["refdb_build_s"] = build
    return System(config, session, refs, orgs, names, build, t)


def set_cache_env() -> None:
    """Point every build and kernel cache of the program at fixed
    directories inside the checkout."""
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(paths.ROOT / "build" /
                                              "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(paths.ROOT / "build" / "triton")
