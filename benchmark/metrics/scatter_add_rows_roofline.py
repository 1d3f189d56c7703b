"""scatter_add_rows's share of its bytes roofline, in percent
(readers.scatter_add_rows_roofline, its byte count and reasons); moves
train_rays_per_s.hash."""

from benchmark.readers import scatter_add_rows_roofline as read  # noqa: F401
