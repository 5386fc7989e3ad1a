"""Kernel launches the host made a training step: the launch calls
(``cudaLaunchKernel`` and its kin, graph launches) in the traced window
over its steps; a count of host dispatch."""


def read(ctx):
    if ctx.trace.launches == 0:
        return None
    return ctx.trace.launches / ctx.units
