"""The numbers that decide ``correct``, on given tensors: a gradient's
place on the line between a part of the batch's gradient and the whole's,
the first step's points and renders, and the verdict."""

from __future__ import annotations

import math

import pytest
import torch

from benchmark import check


def _grads(seed: int) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(50, 4, generator=g),
            "b": torch.randn(7, generator=g)}


@pytest.mark.parametrize("start", ["grad1_rank0", "grad1_half"])
@pytest.mark.parametrize("t,noise", [(1.0, 0.0), (0.0, 0.0), (0.25, 0.0),
                                     (1.0, 1e-3)])
def test_exchange_gap_places_the_gradient_on_the_line(t, noise, start):
    g0, g1, e = _grads(1), _grads(2), _grads(3)
    prog = {"grad1": {k: g0[k] + t * (g1[k] - g0[k]) + noise * e[k]
                      for k in g0}}
    ref = {"grad1": g1, start: g0}
    assert check.line_gap(prog, ref, start) == pytest.approx(abs(1 - t),
                                                             abs=1e-3)


def _first(points, sil, depth=None):
    return {"points": points, "silhouette": sil, "depth": depth}


def test_first_gaps():
    ref = _first(torch.ones(2, 5, 3), torch.zeros(4, 8, 8),
                 torch.ones(4, 8, 8))
    prog = _first(ref["points"].clone(), ref["silhouette"] + 0.25,
                  ref["depth"].clone())
    prog["points"][1] *= 1.5  # one sample's points half again as far out
    gaps = check.first_gaps(prog, ref)
    assert gaps["points_gap"] == pytest.approx(0.5)
    assert gaps["render_gap"] == pytest.approx(0.25)


@pytest.mark.parametrize("prog", [
    None,  # the program made no renderer call
    _first(torch.ones(1, 5, 3), torch.zeros(2, 8, 8), torch.ones(2, 8, 8)),
    _first(torch.ones(2, 5, 3), torch.zeros(4, 8, 8), None)])
def test_first_gaps_of_missing_answers_are_infinite(prog):
    ref = _first(torch.ones(2, 5, 3), torch.zeros(4, 8, 8),
                 torch.ones(4, 8, 8))
    assert check.first_gaps(prog, ref) == {"points_gap": math.inf,
                                           "render_gap": math.inf}


def test_verdict():
    ok, checks = check.verdict({"a": 1.0, "b": 3.0}, {"a": 2.0})
    assert ok and checks == {"a": {"value": 1.0, "limit": 2.0}}
    assert not check.verdict({"a": 3.0}, {"a": 2.0})[0]
    assert not check.verdict({}, {"a": 2.0})[0]  # a number not read fails
    assert not check.verdict({"a": 1.0}, {})[0]  # no limit, no verdict
