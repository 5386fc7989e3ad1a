"""dpcx_torch — the PyTorch/CUDA port of dpcx.

The JAX package ``dpcx/`` is the reference; this package computes the same
functions with PyTorch ops and, where ``dpcx/`` has a Pallas TPU kernel,
with a kernel written by hand for NVIDIA Hopper (``csrc/``). Module names
mirror ``dpcx/`` so each counterpart is easy to find. Public functions keep
the JAX layouts: ``[B, N, 3]`` clouds, wxyz quaternions, ``[B, D, D]``
images and NHWC images at the model's input.

This package never imports ``jax``.

Ported so far (serving, datagen and GT-pose training):

- ``config``    — re-export of ``dpcx.config`` (plain Python + YAML).
- ``geometry``  — quaternion and camera math.
- ``render``    — transform, scatter splat (with rgb and point dropout),
  Gaussian blur, DRC, and the fused splat->blur->DRC renderer
  (``render/fused.py``): CUDA kernels for its forward (K1) and backward
  (K2) behind a ``torch.autograd.Function``.
- ``nets`` / ``models`` — encoder, decoder, model, GT-pose loss.
- ``data``      — synthetic datagen, npz shards, batching.
- ``train``     — the GT-pose training loop, checkpoints, metrics.
- ``convert``   — flax params and optax Adam state -> torch.
- ``serve`` / ``cli`` — the HTTP predictor and the ``datagen``,
  ``train`` and ``serve`` verbs.
- ``utils``     — cloud renders and PNG grids for summaries.
"""

__version__ = "0.2.0"
