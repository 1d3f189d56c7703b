"""Median device ms of hash_train's march spans under render a traced step
(spans.march_ms); moves train_rays_per_s.hash."""

from benchmark.spans import march_ms as read  # noqa: F401
