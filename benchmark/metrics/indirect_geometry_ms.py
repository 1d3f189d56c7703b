"""Median device ms a traced step of shiny3_indir_train's pass 1 (span indirect.geometry)
(readers_indirect.indirect_geometry_ms); moves train_rays_per_s.cp."""

from benchmark.readers_indirect import indirect_geometry_ms as read  # noqa: F401
