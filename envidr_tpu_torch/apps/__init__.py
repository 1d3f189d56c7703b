"""The port's applications (counterparts of ``envidr_tpu/apps/``)."""
