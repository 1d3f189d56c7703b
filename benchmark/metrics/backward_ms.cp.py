"""Median device ms of cp_train's backward span a traced step
(spans.backward_ms); moves train_rays_per_s.cp."""

from benchmark.spans import backward_ms as read  # noqa: F401
