"""rt_frame_roofline.*: `rtbench.roofline`'s lower bound of a frame over
the frame kernel's mean launch time, in %."""

from rtbench.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "rt_frame")
