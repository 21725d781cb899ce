from repro_torch.launch.mesh import (Mesh, make_host_mesh, make_mesh,
                                     make_production_mesh)

__all__ = ["Mesh", "make_host_mesh", "make_mesh", "make_production_mesh"]
