"""Device meshes for the sharded fragment fleet (``mesh.py``)."""
from .mesh import SWITCH_AXIS, SwitchMesh, make_switch_mesh, shard_frag_bounds

__all__ = ["SWITCH_AXIS", "SwitchMesh", "make_switch_mesh",
           "shard_frag_bounds"]
