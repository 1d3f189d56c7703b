"""Median of hash_train's grid-refresh step times, ms
(readers.grid_refresh_step_ms); moves train_step_ms_p95.hash."""

from benchmark.readers import grid_refresh_step_ms as read  # noqa: F401
