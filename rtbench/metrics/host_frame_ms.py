"""host_frame_ms.*: the host's ms a frame in the calls that make it, the
pose (`camera.orbit_camera`), the render call (`build_scalars` and the
`fused_radiance` launch) and `run.HostCopies.enqueue`, from the traced
slice's rtbench spans. The render call's pageable upload waits for the
stream, so where the card is busy with the frame before (a kernel-paced
cell) the span holds that wait and not host work."""

from rtbench.readers import host_steps_ms


def read(ctx):
    return host_steps_ms(ctx, ("rtbench.pose", "rtbench.render",
                               "rtbench.enqueue"))
