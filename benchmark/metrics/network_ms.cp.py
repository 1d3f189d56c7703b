"""Median device ms of cp_train's geometry and color spans less their encode
spans a traced step (spans.network_ms); moves train_rays_per_s.cp."""

from benchmark.spans import network_ms as read  # noqa: F401
