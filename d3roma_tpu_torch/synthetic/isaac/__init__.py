"""Port of `d3roma_tpu/synthetic/isaac/`, on numpy, with the JAX package's exports.

Isaac Sim replicator, backend-abstracted (see replicator.py).

Public surface: IsaacReplicator + ReplicatorConfig (orchestration),
SimBackend/OmniBackend (rendering), plus the pure pieces — geometry,
materials, writers — individually importable and unit-testable.
"""

from d3roma_tpu_torch.synthetic.isaac.backend import OmniBackend, SimBackend  # noqa: F401
from d3roma_tpu_torch.synthetic.isaac.geometry import (  # noqa: F401
    camera_orbit_poses,
    look_at_quaternion,
    mat2quat,
    mesh_center_from_obb,
    obb_corners,
    surface_center_from_obb,
)
from d3roma_tpu_torch.synthetic.isaac.materials import (  # noqa: F401
    MATERIAL_CLASSES,
    assign_materials,
    sample_material_spec,
    sample_scene_materials,
)
from d3roma_tpu_torch.synthetic.isaac.replicator import (  # noqa: F401
    IsaacReplicator,
    ReplicatorConfig,
)
from d3roma_tpu_torch.synthetic.isaac.writers import (  # noqa: F401
    ColorWriter,
    FileBackend,
    FrameTicker,
    GtWriter,
    IRWriter,
)
