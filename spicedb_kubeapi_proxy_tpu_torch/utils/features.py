"""Feature switches of the torch port.

`MESH_EXECUTION` is the killswitch of the sharded mesh path behind
`torch://?mesh=` (the reference's `MeshExecution` gate,
utils/features.py:168, default on).  Off, `torch://?mesh=auto` builds no
mesh and an explicit `mesh=DxG` is a configuration error, as in the
reference.
"""

MESH_EXECUTION = True
