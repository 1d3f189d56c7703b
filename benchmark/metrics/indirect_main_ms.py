"""Median device ms a traced step of shiny3_indir_train's pass 3 (span indirect.main)
(readers_indirect.indirect_main_ms); moves train_rays_per_s.cp."""

from benchmark.readers_indirect import indirect_main_ms as read  # noqa: F401
