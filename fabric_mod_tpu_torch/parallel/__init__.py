"""Device meshes for the batch verify (the port of
fabric_mod_tpu/parallel/)."""
from fabric_mod_tpu_torch.parallel.mesh import (  # noqa: F401
    data_mesh, lane_ranges, slice_meshes)
