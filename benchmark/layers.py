"""Device kernels by layer, from their names in a ``torch.profiler`` trace.

The map is the port's own step breakdown's (its smoke script's
``STEP_LAYERS``), frozen here, with the NCCL kernels of the parallel layer
added first. The first layer whose pattern occurs in a kernel's name takes
it. One approximation is the port's: ``blur_slab_kernel`` runs once in the
renderer's forward and once in its backward, and its time is split half to
each. Every metric here reads the renderer as a whole, where the split
cancels.
"""

from __future__ import annotations

RENDER_FWD = "renderer forward (K1 / K3)"
RENDER_BWD = "renderer backward (K2 / K4 + K5)"
SPLAT_FWD = "splat renderer forward (K6)"
SPLAT_BWD = "splat renderer backward (K7)"
PARALLEL = "parallel (NCCL)"
DRAWS = "random draws (csrc/prng.cu)"
ADAM = "Adam (foreach)"
OTHER = "other (elementwise, reductions, indexing)"
LAYERS = (
    (PARALLEL, ("nccl",)),
    (DRAWS, ("dropout_weights_kernel", "batch_draws_kernel")),
    (SPLAT_BWD, ("aniso_bwd_kernel",)),
    (SPLAT_FWD, ("aniso_fwd_kernel",)),
    (RENDER_BWD, ("drc_bwd_kernel", "drc_bwd_tile_kernel",
                  "blur_z_kernel<true", "splat_bwd_kernel")),
    (RENDER_FWD, ("zblur_drc_kernel", "blur_z_kernel<false",
                  "splat_kernel")),
    (ADAM, ("multi_tensor_apply",)),
    ("GEMMs", ("gemm", "nvjet", "cutlass", "sm90_xmma")),
    ("convs", ("conv", "cudnn", "dgrad", "wgrad", "implicit")),
    ("copies, dtype casts, memsets", ("Memcpy", "Memset", "copy_kernel")),
)
RENDERER = (RENDER_FWD, RENDER_BWD, SPLAT_FWD, SPLAT_BWD)
MODEL_LOSS = ("GEMMs", "convs", "copies, dtype casts, memsets", OTHER)
SPLIT_HALF = "blur_slab_kernel"


def layer_of(name: str) -> str:
    return next((layer for layer, pieces in LAYERS
                 if any(p in name for p in pieces)), OTHER)


def layer_seconds(ops: list[tuple[str, float]]) -> dict[str, float]:
    """Seconds by layer of device operations ``(name, seconds)``."""
    out = {layer: 0.0 for layer, _ in LAYERS}
    out[OTHER] = 0.0
    for name, s in ops:
        if SPLIT_HALF in name:
            out[RENDER_FWD] += s / 2
            out[RENDER_BWD] += s / 2
        else:
            out[layer_of(name)] += s
    return out
