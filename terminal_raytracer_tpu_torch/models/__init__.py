"""Scene data model (JSON schema, procedural scenes, meshes, textures,
animators) and fly camera — the port's own copy of
``terminal_raytracer_tpu/models`` (numpy only), with its packaged scenes and
meshes, so that the port never imports the JAX package. The modules keep
their counterparts' names and contents; tests/test_torch_scale.py holds
``load_scene`` equal to the JAX package's field by field."""

from .camera import Camera  # noqa: F401
from .scene import Scene, list_scenes, load_scene, scene_from_dict  # noqa: F401
