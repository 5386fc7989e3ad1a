"""The fused renderer's bfloat16 operand mode (K1 forward, K2 backward)
against dpcx's Pallas kernels in that mode (CPU).

dpcx's side runs in a subprocess with ``--xla_allow_excess_precision=false``
added to ``XLA_FLAGS``: XLA:CPU's default keeps f32 where the kernels type
bfloat16 (a jitted bf16 x bf16 product then differs from the rounded
product by up to ~2e-3), so in-process interpret mode would not compute
the bfloat16 function. The flag must be set before JAX initialises, which
``tests/conftest.py`` does in this process; so one module-scoped fixture
writes the inputs to an npz, runs ``pallas_project_t(..., interpret=True)``
and its VJP there in both modes, and reads the results back.

Bound: the port's plain bfloat16 version is at most 0.25 x the distance
between dpcx-bf16 and dpcx-f32 on the same inputs from dpcx-bf16 (max abs
for sil and depth, relative L2 for the gradients). That holds only if the
rounding points are dpcx's: a version that rounded elsewhere, or not at
all, lands about as far from dpcx-bf16 as dpcx-f32 does.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dpcx_torch.render import fused
from torch_workers import share_cores

share_cores()

REPO = Path(__file__).resolve().parent.parent
SHARE = 0.25
# name, renders, points, D, radius, depth; every case with point weights
CASES = [
    ("d16_depth", 3, 300, 16, 2, True),
    ("d16", 3, 300, 16, 2, False),
    ("d32_depth", 2, 700, 32, 4, True),
    ("d32", 2, 700, 32, 4, False),
]
NAMES = [c[0] for c in CASES]

DPCX_SCRIPT = r"""
import sys

import jax
import jax.numpy as jnp
import numpy as np

jax.config.update("jax_platforms", "cpu")
from dpcx.render.pallas_kernel import pallas_project_t

inp = dict(np.load(sys.argv[1]))
out = {}
for name in inp["names"]:
    name = str(name)
    vox, radius, depth = (int(v) for v in inp[name + "__meta"])
    sigma = jnp.float32(inp[name + "__sigma"])
    for acc in ("float32", "bfloat16"):
        def render(ndc, pw):
            sil, dep = pallas_project_t(
                ndc, vox, sigma, radius, point_weights=pw,
                with_depth=bool(depth), acc_dtype=acc, interpret=True)
            return (sil, dep) if depth else (sil,)

        prim, vjp = jax.vjp(render, jnp.asarray(inp[name + "__ndc"]),
                            jnp.asarray(inp[name + "__pw"]))
        cts = (jnp.asarray(inp[name + "__dsil"]),)
        if depth:
            cts += (jnp.asarray(inp[name + "__ddepth"]),)
        d_ndc, d_pw = vjp(cts)
        out[f"{name}__{acc}__sil"] = np.asarray(prim[0])
        if depth:
            out[f"{name}__{acc}__depth"] = np.asarray(prim[1])
        out[f"{name}__{acc}__d_ndc"] = np.asarray(d_ndc)
        out[f"{name}__{acc}__d_pw"] = np.asarray(d_pw)
np.savez(sys.argv[2], **out)
"""


def _inputs(case):
    name, renders, n, vox, radius, depth = case
    rng = np.random.default_rng(vox * 31 + n + depth)
    # half on a shell (dense cells), half in a box wider than the grid
    shell = rng.normal(size=(renders, 3, n // 2))
    shell *= 0.3 / np.linalg.norm(shell, axis=1, keepdims=True)
    box = rng.uniform(-0.6, 0.6, (renders, 3, n - n // 2))
    return {
        "ndc": np.concatenate([shell, box], 2).astype(np.float32),
        "pw": rng.uniform(0.0, 2.0, (renders, n)).astype(np.float32),
        "dsil": rng.normal(size=(renders, vox, vox)).astype(np.float32),
        "ddepth": rng.normal(size=(renders, vox, vox)).astype(np.float32),
        "sigma": np.float32(0.08 * vox),
        "meta": np.array([vox, radius, int(depth)]),
    }


@pytest.fixture(scope="module")
def dpcx_results(tmp_path_factory):
    """dpcx's forward and gradients in both modes, every case, from one
    subprocess with excess precision off."""
    tmp = tmp_path_factory.mktemp("bf16")
    arrays = {"names": np.array(NAMES)}
    inputs = {}
    for case in CASES:
        inputs[case[0]] = _inputs(case)
        for k, v in inputs[case[0]].items():
            arrays[f"{case[0]}__{k}"] = v
    np.savez(tmp / "in.npz", **arrays)
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_allow_excess_precision=false").strip()
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in [env.get("PYTHONPATH")] if p])
    proc = subprocess.run(
        [sys.executable, "-c", DPCX_SCRIPT, str(tmp / "in.npz"),
         str(tmp / "out.npz")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(tmp / "out.npz") as f:
        return inputs, {k: f[k] for k in f.files}


def _port(inp, vox, radius, depth, grads: bool):
    ndc = torch.from_numpy(inp["ndc"]).requires_grad_(grads)
    pw = torch.from_numpy(inp["pw"]).requires_grad_(grads)
    sil, dep = fused.fused_project_t(
        ndc, vox, torch.tensor(inp["sigma"]), radius, point_weights=pw,
        with_depth=depth, acc_dtype="bfloat16")
    if not grads:
        return sil, dep
    loss = (sil * torch.from_numpy(inp["dsil"])).sum()
    if depth:
        loss = loss + (dep * torch.from_numpy(inp["ddepth"])).sum()
    return torch.autograd.grad(loss, (ndc, pw))


@pytest.mark.parametrize("case", CASES, ids=NAMES)
def test_bf16_forward_matches_dpcx(case, dpcx_results):
    """sil and depth of the port's bfloat16 mode: within SHARE of
    |dpcx-bf16 - dpcx-f32| (max abs) from dpcx-bf16."""
    inputs, ref = dpcx_results
    name, _, _, vox, radius, depth = case
    with torch.no_grad():
        sil, dep = _port(inputs[name], vox, radius, depth, grads=False)
    outs = [("sil", sil)] + ([("depth", dep)] if depth else [])
    assert dep is None or depth
    for key, got in outs:
        want = ref[f"{name}__bfloat16__{key}"]
        f32 = ref[f"{name}__float32__{key}"]
        err = np.abs(got.numpy() - want).max()
        dist = np.abs(want - f32).max()
        print(f"{name} {key}: port vs dpcx-bf16 {err:.3e}, dpcx-bf16 vs "
              f"dpcx-f32 {dist:.3e}")
        assert dist > 1e-4, (key, dist)  # the modes do differ
        assert err <= SHARE * dist, (key, err, dist)


@pytest.mark.parametrize("case", CASES, ids=NAMES)
def test_bf16_gradients_match_dpcx(case, dpcx_results):
    """d ndc and d weights through the port's plain bfloat16 backward
    (``fused_backward_reference`` behind the CPU autograd.Function) against
    dpcx's K2 in bfloat16 mode: relative L2 within SHARE of dpcx-bf16's
    relative L2 distance to dpcx-f32."""
    inputs, ref = dpcx_results
    name, _, _, vox, radius, depth = case
    got = _port(inputs[name], vox, radius, depth, grads=True)
    for key, g in zip(("d_ndc", "d_pw"), got):
        want = ref[f"{name}__bfloat16__{key}"]
        f32 = ref[f"{name}__float32__{key}"]
        norm = np.linalg.norm(want)
        err = np.linalg.norm(g.numpy() - want) / norm
        dist = np.linalg.norm(want - f32) / norm
        print(f"{name} {key}: port vs dpcx-bf16 {err:.3e}, dpcx-bf16 vs "
              f"dpcx-f32 {dist:.3e} (relative L2)")
        assert dist > 1e-4, (key, dist)
        assert err <= SHARE * dist, (key, err, dist)


def test_bf16_plain_backward_wiring(rng):
    """The CPU autograd.Function hands the cotangents to
    fused_backward_reference unchanged (only sil reaching the loss: a zero
    depth cotangent), and returns no weight gradient without weights."""
    vox, radius = 16, 2
    ndc = torch.from_numpy(rng.uniform(-0.45, 0.45, (2, 3, 200))
                           .astype(np.float32))
    dsil = torch.from_numpy(rng.normal(size=(2, vox, vox))
                            .astype(np.float32))
    sigma = torch.tensor(1.2)
    x = ndc.clone().requires_grad_()
    sil, dep = fused.fused_project_t(x, vox, sigma, radius, with_depth=True,
                                     acc_dtype="bfloat16")
    (sil * dsil).sum().backward()
    want, dw = fused.fused_backward_reference(ndc, vox, sigma, radius, None,
                                              True, dsil, None, "bfloat16")
    torch.testing.assert_close(x.grad, want, atol=0, rtol=0)
    assert dw.shape == (2, 200)
    sil_f, dep_f = fused.fused_project_reference(ndc, vox, sigma, radius,
                                                 with_depth=True,
                                                 acc_dtype="bfloat16")
    torch.testing.assert_close(sil.detach(), sil_f, atol=0, rtol=0)
    torch.testing.assert_close(dep.detach(), dep_f, atol=0, rtol=0)
    assert not any(fused.LAUNCHES.values())  # CPU: no kernel launches


@pytest.mark.parametrize("case", CASES, ids=NAMES)
def test_f32_plain_backward_matches_dpcx(case, dpcx_results):
    """fused_project_plain in float32 mode (K2's function written out, the
    plain side of kernel-vs-plain checks on the card): its forward and
    gradients against dpcx's float32 Pallas kernels, atol 2e-5 and 1e-4
    (ROADMAP's tolerances)."""
    inputs, ref = dpcx_results
    name, _, _, vox, radius, depth = case
    inp = inputs[name]
    ndc = torch.from_numpy(inp["ndc"]).requires_grad_()
    pw = torch.from_numpy(inp["pw"]).requires_grad_()
    sil, dep = fused.fused_project_plain(
        ndc, vox, torch.tensor(inp["sigma"]), radius, point_weights=pw,
        with_depth=depth)
    np.testing.assert_allclose(sil.detach().numpy(),
                               ref[f"{name}__float32__sil"], atol=2e-5)
    loss = (sil * torch.from_numpy(inp["dsil"])).sum()
    if depth:
        loss = loss + (dep * torch.from_numpy(inp["ddepth"])).sum()
    for key, g in zip(("d_ndc", "d_pw"), torch.autograd.grad(loss,
                                                              (ndc, pw))):
        want = ref[f"{name}__float32__{key}"]
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(g.numpy(), want, atol=1e-4, err_msg=key)
