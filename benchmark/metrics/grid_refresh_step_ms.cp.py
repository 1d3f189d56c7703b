"""Median of cp_train's grid-refresh step times, ms
(readers.grid_refresh_step_ms); moves train_rays_per_s.cp."""

from benchmark.readers import grid_refresh_step_ms as read  # noqa: F401
