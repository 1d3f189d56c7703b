"""Share of shiny3_indir_train's pass-2 sample slots that hold a sample, in
percent over the traced steps (readers_indirect.indirect_reflect_slot_use);
moves train_rays_per_s.cp."""

from benchmark.readers_indirect import indirect_reflect_slot_use as read  # noqa: F401
