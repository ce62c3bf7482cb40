from crt_tpu_torch.scene.json_loader import (
    SceneFormatError,
    load_scene,
    scene_from_dict,
    scene_from_json,
)
from crt_tpu_torch.scene.types import RenderSettings, Scene

__all__ = [
    "Scene",
    "RenderSettings",
    "SceneFormatError",
    "load_scene",
    "scene_from_dict",
    "scene_from_json",
]
