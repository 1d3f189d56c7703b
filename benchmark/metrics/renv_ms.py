"""Median device ms a traced step of shiny3_indir_train's renv branch (span renv)
(readers_indirect.renv_ms); moves train_rays_per_s.cp."""

from benchmark.readers_indirect import renv_ms as read  # noqa: F401
