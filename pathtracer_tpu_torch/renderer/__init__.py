from pathtracer_tpu_torch.renderer.bdpt_renderer import render_bdpt
from pathtracer_tpu_torch.renderer.output import output_film
from pathtracer_tpu_torch.renderer.persistent import render_regen
from pathtracer_tpu_torch.renderer.splatted import render_splatted

__all__ = ["render_regen", "render_splatted", "render_bdpt", "output_film"]
