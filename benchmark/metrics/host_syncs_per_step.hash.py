"""Host syncs a traced hash_train step, made and implicit
(spans.host_syncs_per_step); moves train_rays_per_s.hash."""

from benchmark.spans import host_syncs_per_step as read  # noqa: F401
