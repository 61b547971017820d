"""Launch: the production meshes and the multi-pod dry run on a fake
process group (``python -m repro_torch.launch.dryrun``)."""
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh

__all__ = ["make_host_mesh", "make_production_mesh"]
