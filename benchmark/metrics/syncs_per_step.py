"""Host syncs a training step: the CUDA runtime's synchronising calls
(``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
``cudaEventSynchronize``) in the traced window over its steps. Each one
drains the card's queue and leaves the card idle until the host is ahead
again; the window's read-backs between chunks count among them."""

SUFFIX = "Synchronize"


def read(ctx):
    if not ctx.trace.host:
        return None
    syncs = sum(1 for name, _, _ in ctx.trace.host
                if name.endswith(SUFFIX))
    return syncs / ctx.units
