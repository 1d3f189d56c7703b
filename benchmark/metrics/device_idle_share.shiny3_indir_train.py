"""The device's idle share of the shiny3_indir_train window, in percent
(readers.idle_share_train); moves train_rays_per_s.cp."""

from benchmark.readers import idle_share_train as read  # noqa: F401
