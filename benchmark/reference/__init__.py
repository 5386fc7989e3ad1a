"""The plain reference the benchmark judges the port by: plain torch ops in
float32 with TF32 off, importing nothing of the port. ``prng``: the
training step's random draws; ``render``: the point-cloud renderer;
``model``: the model, its GT-pose loss, Adam and the training steps."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def exact_f32():
    """Float32 products in float32 (TF32 off) inside the block."""
    import torch

    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
