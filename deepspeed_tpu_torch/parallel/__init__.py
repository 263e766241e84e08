from .topology import (DATA_AXIS, DP_AXES, EXPERT_AXIS, MESH_AXES,
                       MODEL_AXIS, PIPE_AXIS, SEQ_AXIS, DeviceMeshManager,
                       ProcessTopology, get_mesh_manager, initialize_mesh,
                       reset_mesh)
