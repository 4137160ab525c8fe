"""accumulate_ms: the host's ms a frame in the wait for the frame's copy
(`run.HostCopies` event) and `render.Accumulator.add`, from the traced
slice's rtbench spans; None where nothing was folded. Moves
msamples_per_s."""

from rtbench.readers import host_steps_ms


def read(ctx):
    return host_steps_ms(ctx, ("rtbench.wait", "rtbench.fold"),
                         need="rtbench.fold")
