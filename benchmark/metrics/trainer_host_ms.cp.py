"""Median host time of cp_train's train_step calls, ms
(readers.trainer_host_ms); moves train_rays_per_s.cp."""

from benchmark.readers import trainer_host_ms as read  # noqa: F401
