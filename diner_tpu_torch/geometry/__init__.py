from diner_tpu_torch.geometry.normals import depth_to_normal
from diner_tpu_torch.geometry.rays import gen_rays
from diner_tpu_torch.geometry.transforms import (
    project_points,
    rotate_to_cam,
    uv_to_ndc,
    world_to_cam,
)

__all__ = ["depth_to_normal", "gen_rays", "project_points", "rotate_to_cam",
           "uv_to_ndc", "world_to_cam"]
