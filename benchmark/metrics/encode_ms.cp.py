"""Median device ms of cp_train's encode spans under render a traced step, the
forward encode (spans.encode_ms); moves train_rays_per_s.cp."""

from benchmark.spans import encode_ms as read  # noqa: F401
