"""rt_frame_ms.*: the device ms of one launch of the frame kernel
(`csrc/frame.cu` `rt_frame_kernel`), mean over the traced slice's whole
launches."""

from rtbench.readers import kernel_ms


def read(ctx):
    return kernel_ms(ctx, "rt_frame")
