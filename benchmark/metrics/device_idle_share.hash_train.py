"""The device's idle share of the hash_train window, in percent
(readers.idle_share_train); moves train_rays_per_s.hash."""

from benchmark.readers import idle_share_train as read  # noqa: F401
