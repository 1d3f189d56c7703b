"""Share of cp_train's K x N march slots that hold a sample over the traced
steps, in percent (spans.march_slot_use); moves train_rays_per_s.cp."""

from benchmark.spans import march_slot_use as read  # noqa: F401
