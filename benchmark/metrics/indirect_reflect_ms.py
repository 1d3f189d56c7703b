"""Median device ms a traced step of shiny3_indir_train's pass 2 (span indirect.reflect)
(readers_indirect.indirect_reflect_ms); moves train_rays_per_s.cp."""

from benchmark.readers_indirect import indirect_reflect_ms as read  # noqa: F401
