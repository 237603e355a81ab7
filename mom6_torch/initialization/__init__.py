"""Initial state from files: horizontal regridding of lat-lon source
data and z-space initial conditions (counterpart of
``mom6_tpu.initialization``)."""

from mom6_torch.initialization.horizontal_regrid import (  # noqa: F401
    bilinear_regrid, fill_missing)
from mom6_torch.initialization.z_init import (  # noqa: F401
    temp_salt_from_z, thickness_from_z_edges, tracer_from_z,
    z_edges_from_centers)
