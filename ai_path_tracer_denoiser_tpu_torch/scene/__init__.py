from .structs import (  # noqa: F401
    SPHERE,
    CUBE,
    Geoms,
    Materials,
    MeshData,
    Camera,
    Scene,
    build_transformation_matrix,
    empty_mesh,
    pad_faces,
)
from .parser import load_scene, parse_scene_text  # noqa: F401
from .camera import derive_camera, orbit_camera, orbit_params_from_camera  # noqa: F401
from .obj_loader import load_obj  # noqa: F401
from .randomizer import randomize_scene_text  # noqa: F401
