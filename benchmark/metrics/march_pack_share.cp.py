"""The rows that cp_train's and shiny3_indir_train's packed renders ran their
per-sample work on, padding included, in percent of those renders' sample
slots over the traced steps (readers_pack.march_pack_share); moves
train_rays_per_s.cp."""

from benchmark.readers_pack import march_pack_share as read  # noqa: F401
