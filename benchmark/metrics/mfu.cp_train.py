"""cp_train's model FLOPs over 67 TFLOP/s, in percent (readers.mfu, its count
and reasons); moves train_rays_per_s.cp."""

from benchmark.readers import mfu as read  # noqa: F401
