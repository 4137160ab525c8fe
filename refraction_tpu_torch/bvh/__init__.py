"""Triangle ordering and cluster boxes: the port's copies of `refraction_tpu.bvh` (numpy)."""
