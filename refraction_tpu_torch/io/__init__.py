"""Asset IO: the port's copies of `refraction_tpu.io` (pure Python)."""
