"""shiny3_indir_train's model FLOPs over 67 TFLOP/s, in percent
(readers_indirect.mfu, its count and reasons); moves train_rays_per_s.cp."""

from benchmark.readers_indirect import mfu as read  # noqa: F401
