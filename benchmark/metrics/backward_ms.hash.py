"""Median device ms of hash_train's backward span a traced step
(spans.backward_ms); moves train_rays_per_s.hash."""

from benchmark.spans import backward_ms as read  # noqa: F401
