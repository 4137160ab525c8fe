"""Host utilities: the port's copies of `refraction_tpu.utils`."""
