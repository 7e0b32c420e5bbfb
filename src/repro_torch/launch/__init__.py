"""Device meshes (``mesh.py``): the sharded fragment fleet's ``switch``
mesh and the model's production meshes."""
from .mesh import (SWITCH_AXIS, AbstractMesh, SwitchMesh, make_mesh,
                   abstract_production_mesh, data_axis_size, make_host_mesh,
                   make_production_mesh, make_switch_mesh, process_group,
                   shard_frag_bounds)

__all__ = ["SWITCH_AXIS", "AbstractMesh", "SwitchMesh",
           "abstract_production_mesh", "data_axis_size", "make_host_mesh",
           "make_mesh",
           "make_production_mesh", "make_switch_mesh", "process_group",
           "shard_frag_bounds"]
