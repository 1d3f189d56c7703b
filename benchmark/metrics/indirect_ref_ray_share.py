"""Share of shiny3_indir_train's rays whose reflection mask is on, in percent
over the traced steps (readers_indirect.indirect_ref_ray_share); moves
train_rays_per_s.cp."""

from benchmark.readers_indirect import indirect_ref_ray_share as read  # noqa: F401
