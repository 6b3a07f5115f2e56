"""Process groups for the port's sharded profiling (counterpart of the
profiling part of :mod:`repro.distributed`)."""

from repro_torch.distributed.sharding import (PROFILE_RULES, ProfileMesh,
                                              make_profile_mesh)

__all__ = ["PROFILE_RULES", "ProfileMesh", "make_profile_mesh"]
