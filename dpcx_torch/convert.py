"""Flax parameters -> a ``state_dict`` for ``dpcx_torch.models.model_pc``.

Takes the flax params tree as nested dicts of numpy arrays (with or
without the top-level ``"params"`` key). Module paths map one to one
(``encoder/conv{i}``, ``encoder/fc1``, ``encoder/fc_latent``,
``encoder/fc_pose``, ``decoder/fc{i}``, ``decoder/fc_points``,
``decoder/fc_scale``); a Dense kernel ``[in, out]`` becomes a weight
``[out, in]`` and a Conv kernel HWIO becomes OIHW. The encoder flattens
NHWC as flax does, so ``fc1`` needs no row permutation.

``adam_state_from_optax`` carries optax's Adam state across the same way:
``mu`` -> ``exp_avg``, ``nu`` -> ``exp_avg_sq`` (same layout transposes as
the params) and ``count`` -> ``step``, so a dpcx ``TrainState`` continues
as the port's ``torch.optim.Adam``.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from dpcx_torch.nets.layers import weight_from_kernel


def params_from_flax(tree: Mapping) -> dict[str, torch.Tensor]:
    """Nested flax params (numpy leaves) -> torch state_dict (float32)."""
    tree = tree.get("params", tree)
    out: dict[str, torch.Tensor] = {}

    def walk(node: Mapping, prefix: str) -> None:
        for name, value in node.items():
            if "kernel" in value:
                kernel = np.asarray(value["kernel"])
                for key, arr in (
                    ("weight", weight_from_kernel(kernel)),
                    ("bias", np.asarray(value["bias"])),
                ):
                    out[f"{prefix}{name}.{key}"] = torch.tensor(
                        arr, dtype=torch.float32
                    )
            else:
                walk(value, f"{prefix}{name}.")

    walk(tree, "")
    return out


def adam_state_from_optax(
    mu: Mapping, nu: Mapping, count
) -> dict[str, dict[str, torch.Tensor]]:
    """optax ``ScaleByAdamState`` leaves -> per-parameter Adam state keyed
    by ``state_dict`` name, as ``torch.optim.Adam`` keeps it."""
    exp_avg, exp_avg_sq = params_from_flax(mu), params_from_flax(nu)
    step = float(np.asarray(count))
    return {
        name: {
            "step": torch.tensor(step, dtype=torch.float32),
            "exp_avg": exp_avg[name],
            "exp_avg_sq": exp_avg_sq[name],
        }
        for name in exp_avg
    }
