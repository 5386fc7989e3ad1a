"""Faults planted in the program underneath the timed path, and the
lower-precision controls: what ``correct`` has to come out false for.
They patch the port's modules in this process only; the benchmark's own
runs plant nothing.

    python3 -m benchmark.faults --mode <mode> --workload <name> ...

runs a cell as ``benchmark.run`` does with the fault planted in every
rank. Modes (``calibrate``'s): ``half_batch``, ``half_loss``,
``no_exchange``, ``unchanged``, ``altered``, ``half_renders``;
``render_bf16`` switches the renderer's bf16 mode on in a renderer cell.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys


@contextlib.contextmanager
def planted(mode: str):
    """The port with ``mode``'s fault inside the block (none for
    ``sound`` and the controls)."""
    import torch

    import dpcx_torch.models.losses as losses
    import dpcx_torch.render.project as project
    import dpcx_torch.train as train

    saved = []

    def patch(mod, name, value):
        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, value)

    if mode == "half_batch":  # half the rows left out, the mean of the rest
        update = train.update

        def half(cfg, state, batch, drop_key, *a, **k):
            rows = batch["image"].shape[0] // 2
            return update(cfg, state, {n: v[:rows] for n, v in batch.items()},
                          drop_key, *a, **k)

        patch(train, "update", half)
    elif mode == "half_loss":  # the same, every row rendered and scored
        project_fn = losses.pointcloud_project_fn

        def halved(cfg, points, *a, **k):
            # the renders of the second half of the rows leave the
            # gradient, the first half's count twice: the mean over the
            # first half, with the shapes and the loss's value unchanged
            out = project_fn(cfg, points, *a, **k)
            first = torch.arange(points.shape[0], device=points.device) \
                < points.shape[0] // 2

            def half(x):
                if x is None:
                    return None
                kept = first.view(-1, *[1] * (x.dim() - 1))
                return torch.where(kept, 2 * x - x.detach(), x.detach())

            return dataclasses.replace(out, silhouette=half(out.silhouette),
                                       depth=half(out.depth))

        patch(losses, "pointcloud_project_fn", halved)
    elif mode == "no_exchange":  # each rank steps on its own gradients
        patch(train, "all_mean_", lambda tensors, mesh: None)
    elif mode == "unchanged":  # the step computes but leaves its state
        update = train.update

        def frozen(cfg, state, *a, **k):
            step = state.optimizer.step
            state.optimizer.step = lambda *x, **y: None
            try:
                return update(cfg, state, *a, **k)
            finally:
                state.optimizer.step = step

        patch(train, "update", frozen)
    elif mode in ("altered", "half_renders"):
        project_fn = project.pointcloud_project_fn

        def wrong(cfg, points, *a, **k):
            out = project_fn(cfg, points, *a, **k)
            sil = out.silhouette
            if mode == "altered":  # one pixel of the first render
                bump = sil.new_zeros(sil.shape)
                bump[0, 0, 0] = 0.5
                sil = sil + bump
            else:  # the second half of the renders never made
                keep = sil.new_ones(sil.shape[0])
                keep[sil.shape[0] // 2:] = 0
                sil = sil * keep[:, None, None]
            return type(out)(silhouette=sil, depth=out.depth)

        patch(project, "pointcloud_project_fn", wrong)
    try:
        yield
    finally:
        for mod, name, value in reversed(saved):
            setattr(mod, name, value)


def render_numbers(r, mode: str) -> dict:
    """Every number of a renderer cell's sampled calls, ``r.seconds``
    long (with ``render_bf16``, of the program's bf16 mode)."""
    from benchmark.drivers import render

    if mode == "render_bf16":
        cell = r.cell
        traffic = {**cell.traffic, "config": {**cell.traffic.get("config",
                                                                 {}),
                                              "pallas_acc_dtype": "bfloat16"}}
        r = type(r)(**{**r.__dict__,
                       "cell": type(cell)(**{**cell.__dict__,
                                             "traffic": traffic})})
    return render.measure(r)[1]


def main(argv=None) -> int:
    import argparse

    from benchmark import run

    a = argparse.ArgumentParser(prog="python3 -m benchmark.faults")
    a.add_argument("--mode", required=True)
    args, rest = a.parse_known_args(argv)
    with planted(args.mode):
        return run.main(rest, entry=["-m", "benchmark.faults", "--mode",
                                     args.mode])


if __name__ == "__main__":
    sys.exit(main())
