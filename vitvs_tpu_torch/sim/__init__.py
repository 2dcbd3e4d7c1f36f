from vitvs_tpu_torch.sim.env import env_step, observe
from vitvs_tpu_torch.sim.perturb import perturb_texture
from vitvs_tpu_torch.sim.pointcloud import organized_point_cloud
from vitvs_tpu_torch.sim.scene import (Scene, load_poster_scene, make_synthetic_poster, render,
                                       render_ir)

__all__ = [
    "Scene",
    "render",
    "render_ir",
    "load_poster_scene",
    "make_synthetic_poster",
    "perturb_texture",
    "observe",
    "env_step",
    "organized_point_cloud",
]
