"""dpcx_torch — the PyTorch/CUDA port of dpcx.

The JAX package ``dpcx/`` is the reference; this package computes the same
functions with PyTorch ops and, where ``dpcx/`` has a Pallas TPU kernel,
with a kernel written by hand for NVIDIA Hopper (``csrc/``). Module names
mirror ``dpcx/`` so each counterpart is easy to find. Public functions keep
the JAX layouts: ``[B, N, 3]`` clouds, wxyz quaternions, ``[B, D, D]``
images and NHWC images at the model's input.

This package never imports ``jax``, nor anything of ``dpcx``.

Ported so far (serving, datagen and GT-pose training up to 128^3):

- ``config``    — the port's own copy of ``dpcx/config.py`` (plain Python
  + YAML), field for field.
- ``geometry``  — quaternion and camera math.
- ``render``    — transform, scatter splat (with rgb and point dropout),
  Gaussian blur, DRC, and the fused splat->blur->DRC renderer
  (``render/fused.py``): CUDA kernels for its forward and backward behind
  a ``torch.autograd.Function``, for D <= 128 (the counterparts of K1/K2
  and of the depth-blocked K3-K5), with a saved-grid and a recompute
  backward.
- ``nets`` / ``models`` — encoder, decoder, model, GT-pose loss.
- ``data``      — synthetic datagen, npz shards, batching.
- ``train``     — the GT-pose training loop (with ``remat``),
  checkpoints, metrics.
- ``convert``   — flax params and optax Adam state -> torch.
- ``serve`` / ``cli`` — the HTTP predictor and the ``datagen``,
  ``train`` and ``serve`` verbs.
- ``utils``     — cloud renders and PNG grids for summaries.
"""

__version__ = "0.3.0"
