"""The anisotropic splats' bfloat16 operand mode (K6 forward, K7 backward)
against dpcx's Pallas kernels in that mode (CPU), and one bfloat16 training
step of a small rgb_splats config.

As in ``tests/test_torch_bf16.py``, dpcx's side runs in one module-scoped
subprocess with ``--xla_allow_excess_precision=false`` (XLA:CPU otherwise
keeps f32 where the kernels type bfloat16), in interpret mode, in both
modes, and the results come back through an npz.

The cases are at D 32: there a cell's z z, z y or y y exceeds 256, so K7's
rounded basis (1, z, y, rnd(z z), rnd(z y), rnd(y y)) is not exact and the
raw-moment form differs from a centred one. (At D 16 every product is at
most 225, exact in bfloat16, and no test could tell them apart.) Scales
are rgb_splats' [0.005, 0.06] of the grid, rotations random, the cotangents
random on the density and colour grids.

Bound: the port's plain bfloat16 version is at most 0.25 x the distance
between dpcx-bf16 and dpcx-f32 from dpcx-bf16 (max abs for the density and
colour grids, relative L2 for the gradients of the points, scales,
rotations, opacity and colours; for the training step, the loss and the
relative L2 of the parameter update). A centred K7 with rounded u lands
outside it on the scale gradient.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dpcx_torch import train as ttrain
from dpcx_torch.config import Config as TConfig
from dpcx_torch.convert import adam_state_from_optax, params_from_flax
from dpcx_torch.models import losses as tlosses
from dpcx_torch.render import aniso
from dpcx_torch.render import gsplat as tgs
from dpcx_torch.utils import prng
from torch_workers import share_cores

share_cores()

REPO = Path(__file__).resolve().parent.parent
SHARE = 0.25
D = 32
# name, renders, points, rgb (N 200 pads the last chunk)
CASES = [
    ("rgb", 2, 256, True),
    ("density", 2, 256, False),
    ("rgb_pads", 1, 200, True),
]
NAMES = [c[0] for c in CASES]
GRADS = ("points", "scales", "rot", "opacity", "rgb")
# float32 plain vs dpcx, relative L2: dpcx's f32 K7 sums raw moments and
# centres them, which cancels digits at D 32 where the port's centred sums
# do not; its scale and rotation gradients read 1.1e-4 - 1.4e-3 and
# 2.2e-5 - 2.3e-4 from the port's. test_f32_plain_backward_matches_dpcx
# holds both to the float64 derivative (F64_RTOL), so the distance is
# dpcx's, not the port's
F32_GRAD_RTOL = {"scales": 2e-3, "rot": 5e-4}
F64_RTOL = 2e-5
# the training step's config: rgb_splats' heads and splat path at D 32,
# narrow widths, float32 compute
STEP_CFG = dict(
    vox_size=D, mask_size=D, pc_num_points=64, image_size=32,
    encoder_filters=(8,), latent_dim=16, fc_hidden=16,
    pc_decoder_hidden=(16,), num_views=2, views_per_step=2, batch_size=2,
    compute_dtype="float32", proj_depth=False, drc_weight=0.0,
    learning_rate=1e-4, pc_rgb=True, pc_gauss=True, gsplat_impl="pallas",
    gauss_scale_min=0.005, gauss_scale_max=0.06, pc_point_dropout=0.5,
)

DPCX_SCRIPT = r"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax

jax.config.update("jax_platforms", "cpu")
import dpcx.models.losses as jlosses
from dpcx.config import Config
from dpcx.models.model_pc import ModelPointCloud
from dpcx.render.gsplat import anisotropic_density_grid_pallas
from dpcx.train import TrainState, _prep_batch, train_step

inp = dict(np.load(sys.argv[1]))
names = [str(n) for n in inp["names"]]


def case_fn(name, acc):  # -> (primal, VJP of the cotangents)
    with_rgb = bool(inp[name + "__with_rgb"])

    def render(p, s, r, o, c):
        return anisotropic_density_grid_pallas(
            p, s, r, VOX, point_weights=o, rgb=c if with_rgb else None,
            acc_dtype=acc, interpret=True)

    def run(args, cts):
        prim, vjp = jax.vjp(render, *args)
        return prim, vjp(cts)

    return run


def case_args(name):
    args = [jnp.asarray(inp[f"{name}__{k}"])
            for k in ("points", "scales", "rot", "opacity", "rgb")]
    ct_d = jnp.asarray(inp[name + "__ct_dens"])
    if bool(inp[name + "__with_rgb"]):
        return args, (ct_d, jnp.asarray(inp[name + "__ct_cols"]))
    return args, ct_d


runs = {(name, acc): case_fn(name, acc)
        for name in names for acc in ("float32", "bfloat16")}


@jax.jit  # every case and mode in one compiled program
def all_cases(case_inputs):
    return {key: fn(*case_inputs[key[0]]) for key, fn in runs.items()}


out = {}
for (name, acc), (prim, grads) in all_cases(
        {name: case_args(name) for name in names}).items():
    if bool(inp[name + "__with_rgb"]):
        out[f"{name}__{acc}__dens"] = np.asarray(prim[0])
        out[f"{name}__{acc}__cols"] = np.asarray(prim[1])
    else:
        out[f"{name}__{acc}__dens"] = np.asarray(prim)
    for key, g in zip(GRADS, grads):
        out[f"{name}__{acc}__d_{key}"] = np.asarray(g)


def flat(tree, prefix):
    for k, v in tree.items():
        if hasattr(v, "items"):
            flat(v, f"{prefix}{k}/")
        else:
            out[prefix + k] = np.asarray(v)


# one float32 step warms Adam's moments, then one step in each mode
w = jnp.asarray(inp["step__w"])
jlosses.pc_point_dropout_weights = lambda *a: w
cfg = Config(**STEP_CFG)
batches = [{k[len(f"step__b{i}__"):]: inp[k] for k in inp
            if k.startswith(f"step__b{i}__")} for i in (0, 1)]
key = jax.random.PRNGKey(1)
# create_state's model.init, jitted (eager it dispatches op by op)
model = ModelPointCloud(cfg)
state = TrainState.create(
    apply_fn=model.apply, tx=optax.adam(cfg.learning_rate),
    params=jax.jit(model.init)(jax.random.PRNGKey(0),
                               jnp.zeros((1, cfg.image_size,
                                          cfg.image_size, 3))))
state, _ = train_step(cfg, state, _prep_batch(batches[0], cfg), key)
adam = state.opt_state[0]
flat(jax.device_get(state.params), "warm__params/")
flat(jax.device_get(adam.mu), "warm__mu/")
flat(jax.device_get(adam.nu), "warm__nu/")
out["warm__count"] = np.asarray(adam.count)
out["warm__step"] = np.asarray(state.step)
for acc in ("float32", "bfloat16"):
    c = cfg.replace(pallas_acc_dtype=acc)
    s, m = train_step(c, jax.tree.map(jnp.copy, state),
                      _prep_batch(batches[1], c), key)
    out[f"step__{acc}__loss"] = np.asarray(m["loss_total"])
    flat(jax.device_get(s.params), f"step__{acc}__params/")
np.savez(sys.argv[2], **out)
""".replace("STEP_CFG", repr(STEP_CFG)).replace("VOX", str(D)).replace(
    "GRADS", repr(GRADS))


def _inputs(case):
    name, renders, n, with_rgb = case
    rng = np.random.default_rng(n + renders + 7 * with_rgb)
    q = rng.normal(size=(renders, n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    arrs = {
        "points": rng.uniform(-0.45, 0.45, (renders, n, 3)),
        "scales": rng.uniform(0.005, 0.06, (renders, n, 3)),
        "rot": q,
        "opacity": rng.uniform(size=(renders, n)),
        "rgb": rng.uniform(size=(renders, n, 3)),
        "ct_dens": rng.normal(size=(renders, D, D, D)),
        "ct_cols": rng.normal(size=(renders, D, D, D, 3)),
    }
    out = {k: v.astype(np.float32) for k, v in arrs.items()}
    out["with_rgb"] = np.array(with_rgb)
    return out


def _step_inputs():
    """Two training batches (images, blob masks, depths, unit quats, target
    images) and the point dropout weights both sides use."""
    rng = np.random.default_rng(32)
    B, V = STEP_CFG["batch_size"], STEP_CFG["num_views"]
    S = STEP_CFG["image_size"]
    yy, xx = np.mgrid[:D, :D] / D - 0.5
    out = {"w": ((rng.random((B, STEP_CFG["pc_num_points"])) < 0.5) / 0.5
                 ).astype(np.float32)}
    for i in (0, 1):
        r = rng.uniform(0.15, 0.35, (B, V, 1, 1))
        masks = ((yy**2 + xx**2) < r**2).astype(np.float32)
        q = rng.normal(size=(B, V, 4))
        out.update({
            f"b{i}__image": rng.random((B, S, S, 3)).astype(np.float32),
            f"b{i}__masks": masks,
            f"b{i}__depths": np.where(masks > 0, rng.uniform(
                -0.3, 0.3, masks.shape), 1.0).astype(np.float32),
            f"b{i}__quats": (q / np.linalg.norm(q, axis=-1, keepdims=True)
                             ).astype(np.float32),
            f"b{i}__images_tgt": rng.random((B, V, S, S, 3)).astype(
                np.float32),
        })
    return out


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions walk D slabs of small tensor ops. In the parallel
    test run (6 workers on shared cores) torch's default of one thread per
    core made each op wait on the other workers' threads: a test of 0.4 s
    alone took 15-30 s there. One thread per worker for this module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def dpcx_results(tmp_path_factory):
    """dpcx's forward, gradients and training step in both modes, from one
    subprocess with excess precision off."""
    tmp = tmp_path_factory.mktemp("bf16_splat")
    arrays = {"names": np.array(NAMES)}
    inputs = {}
    for case in CASES:
        inputs[case[0]] = _inputs(case)
        for k, v in inputs[case[0]].items():
            arrays[f"{case[0]}__{k}"] = v
    inputs["step"] = _step_inputs()
    arrays.update({f"step__{k}": v for k, v in inputs["step"].items()})
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


def _port(inp, acc_dtype="bfloat16", grads=True, density_fn=None):
    """The port's anisotropic_density_grid_pallas on the case's inputs ->
    (density, colour grid or None), or the gradients of <cotangents,
    outputs> to GRADS (rgb's None without colour)."""
    with_rgb = bool(inp["with_rgb"])
    ins = [torch.from_numpy(inp[k]).requires_grad_(grads) for k in GRADS]
    out = tgs.anisotropic_density_grid_pallas(
        *ins[:3], D, point_weights=ins[3], rgb=ins[4] if with_rgb else None,
        acc_dtype=acc_dtype, density_fn=density_fn)
    dens, cols = out if with_rgb else (out, None)
    if not grads:
        return dens, cols
    loss = (dens * torch.from_numpy(inp["ct_dens"])).sum()
    if with_rgb:
        loss = loss + (cols * torch.from_numpy(inp["ct_cols"])).sum()
    return torch.autograd.grad(loss, ins, allow_unused=True)


def _check(label, err, dist, floor=1e-5):
    print(f"{label}: port vs dpcx-bf16 {err:.3e}, dpcx-bf16 vs dpcx-f32 "
          f"{dist:.3e}, ratio {err / dist:.3e} (bound {SHARE})")
    assert dist > floor, (label, dist)  # the modes do differ
    assert err <= SHARE * dist, (label, err, dist)


def _accumulators(dens, cols):
    """The colour accumulators sum e rnd(c) [B, D, D, D, 3] from the colour
    grid cols = accumulators / max(density, 1e-6). The grid itself is not
    compared: in a cell whose density is one thin Gaussian's tail, one bf16
    rounding of that e that flips (an f32 ulp of exp differs between XLA
    and PyTorch) moves the quotient by as much as the two modes differ."""
    return cols.astype(np.float64) * np.maximum(dens, 1e-6)[..., None]


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("case", CASES, ids=NAMES)
def test_bf16_splat_forward_matches_dpcx(case, dpcx_results):
    """The density and colour accumulators of K6's bfloat16 mode (e and the
    colours rounded, f32 sums): within SHARE of |dpcx-bf16 - dpcx-f32| (max
    abs) from dpcx-bf16."""
    inputs, ref = dpcx_results
    name, _, _, with_rgb = case
    with torch.no_grad():
        dens, cols = _port(inputs[name], grads=False)
    assert (cols is not None) == with_rgb
    d_b, d_f = (ref[f"{name}__{acc}__dens"] for acc in ("bfloat16",
                                                        "float32"))
    _check(f"{name} density", np.abs(dens.numpy() - d_b).max(),
           np.abs(d_b - d_f).max())
    if with_rgb:
        got, want, f32 = (_accumulators(*a) for a in (
            (dens.numpy(), cols.numpy()),
            (d_b, ref[f"{name}__bfloat16__cols"]),
            (d_f, ref[f"{name}__float32__cols"])))
        _check(f"{name} colour accumulators", np.abs(got - want).max(),
               np.abs(want - f32).max())


@pytest.mark.parametrize("case", CASES, ids=NAMES)
def test_bf16_splat_gradients_match_dpcx(case, dpcx_results):
    """The gradients through K7's bfloat16 mode (the raw moments of rnd(u)
    over the rounded basis, centred in f32) behind the CPU autograd.Function:
    relative L2 within SHARE of dpcx-bf16's relative L2 distance to
    dpcx-f32, for every input."""
    inputs, ref = dpcx_results
    name, _, _, with_rgb = case
    got = _port(inputs[name])
    for key, g in zip(GRADS, got):
        if key == "rgb" and not with_rgb:
            assert g is None
            continue
        want = ref[f"{name}__bfloat16__d_{key}"]
        f32 = ref[f"{name}__float32__d_{key}"]
        _check(f"{name} d {key} (relative L2)", _rel(g.numpy(), want),
               _rel(f32, want))


def test_bf16_splat_needs_the_raw_moments(dpcx_results, monkeypatch):
    """dpcx's bfloat16 scale gradient comes from K7's rounded raw basis: a
    K7 that rounds u and t_c but sums centred moments (the float32 form)
    lands outside the bound, so the gradient test above sees the raw-moment
    form."""
    inputs, ref = dpcx_results
    name = CASES[0][0]
    real_terms, real_bwd = aniso._cell_terms, aniso.aniso_backward_reference

    def rounded_terms(*a):
        u, t = real_terms(*a)
        return aniso._rnd(u), [aniso._rnd(tc) for tc in t]

    def centred(pk, z_lo, z_hi, ct, vox, with_rgb, acc_dtype):
        assert acc_dtype == "bfloat16"
        return real_bwd(pk, z_lo, z_hi, ct, vox, with_rgb, "float32")

    monkeypatch.setattr(aniso, "_cell_terms", rounded_terms)
    monkeypatch.setattr(aniso, "aniso_backward_reference", centred)
    d_scales = _port(inputs[name])[GRADS.index("scales")].numpy()
    want = ref[f"{name}__bfloat16__d_scales"]
    ratio = (_rel(d_scales, want)
             / _rel(ref[f"{name}__float32__d_scales"], want))
    print(f"centred K7 with rounded u: scale gradient ratio {ratio:.3e}")
    assert ratio > SHARE


def _f64_gradients(inp):
    """The float64 derivative of the plain forward (autograd through
    ``_render_plain`` on float64 packed points), at the z-ranges the float32
    inputs give: the witness for the float32 gradients."""
    with_rgb = bool(inp["with_rgb"])
    f32 = [torch.from_numpy(inp[k]) for k in GRADS]
    mu, _, _, rz = tgs.splat_params(*f32[:3], D, f32[3])
    z_lo, z_hi = aniso.z_ranges(mu[..., 0], rz, D)

    def density(mu, A6, w, rgb, rz, vox, acc_dtype):
        rows = [mu.transpose(1, 2), A6.transpose(1, 2), w[:, None],
                rgb.transpose(1, 2) if with_rgb else mu.new_zeros(
                    (mu.shape[0], 3, mu.shape[1]))]
        out = aniso._render_plain(torch.cat(rows, 1), z_lo, z_hi, vox,
                                  with_rgb, acc_dtype)
        return (out[:, 0], out[:, 1:4]) if with_rgb else out[:, 0]

    ins = [t.double().requires_grad_() for t in f32]
    out = tgs.anisotropic_density_grid_pallas(
        *ins[:3], D, point_weights=ins[3], rgb=ins[4] if with_rgb else None,
        density_fn=density)
    dens, cols = out if with_rgb else (out, None)
    loss = (dens * torch.from_numpy(inp["ct_dens"]).double()).sum()
    if with_rgb:
        loss = loss + (cols * torch.from_numpy(inp["ct_cols"]).double()).sum()
    return torch.autograd.grad(loss, ins, allow_unused=True)


@pytest.mark.parametrize("case", CASES, ids=NAMES)
def test_f32_plain_backward_matches_dpcx(case, dpcx_results):
    """aniso_density_plain in float32 mode (K7's centred function written
    out) against dpcx's float32 kernels: the grids within atol/rtol 2e-5,
    the gradients within relative L2 2e-4 (dpcx's own bound for its Pallas
    backward), those of the scales and rotations within F32_GRAD_RTOL. The
    float64 derivative is the witness: the port's gradients lie within
    F64_RTOL of it, and for the scales and rotations dpcx's lies farther
    from it than from the port's."""
    inputs, ref = dpcx_results
    name, _, _, with_rgb = case
    inp = inputs[name]
    got = _port(inp, "float32", density_fn=aniso.aniso_density_plain)
    exact = _f64_gradients(inp)
    for key, g, g64 in zip(GRADS, got, exact):
        if g is None:
            continue
        dpcx = ref[f"{name}__float32__d_{key}"]
        rel = _rel(g.numpy(), dpcx)
        bound = F32_GRAD_RTOL.get(key, 2e-4)
        port64, dpcx64 = _rel(g.numpy(), g64.numpy()), _rel(dpcx, g64.numpy())
        print(f"{name} d {key}: float32 plain vs dpcx {rel:.3e} (bound "
              f"{bound}); vs float64: port {port64:.3e}, dpcx {dpcx64:.3e}")
        assert rel <= bound, (key, rel)
        assert port64 <= F64_RTOL, (key, port64)
        if key in F32_GRAD_RTOL:
            assert dpcx64 >= 0.5 * rel, (key, dpcx64, rel)
    with torch.no_grad():
        dens, cols = _port(inp, "float32", grads=False)
    np.testing.assert_allclose(dens.numpy(), ref[f"{name}__float32__dens"],
                               rtol=2e-5, atol=2e-5)
    if with_rgb:
        np.testing.assert_allclose(cols.numpy(),
                                   ref[f"{name}__float32__cols"],
                                   rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("with_rgb", [True, False])
def test_f32_backward_reference_is_the_derivative(with_rgb, rng):
    """In float32 aniso_backward_reference is the derivative of the plain
    forward (autograd through it), at D 32 with pads: relative L2 within
    1e-5 per gradient row group."""
    n, renders = 200, 2
    q = rng.normal(size=(renders, n, 4))
    pts, scales, rot, opac, rgb = (
        torch.tensor(a, dtype=torch.float32) for a in (
            rng.uniform(-0.45, 0.45, (renders, n, 3)),
            rng.uniform(0.005, 0.06, (renders, n, 3)),
            q / np.linalg.norm(q, axis=-1, keepdims=True),
            rng.uniform(size=(renders, n)),
            rng.uniform(size=(renders, n, 3))))
    mu, A6, w, rz = tgs.splat_params(pts, scales, rot, D, opac)
    z_lo, z_hi = aniso.z_ranges(mu[..., 0], rz, D)
    pk = aniso.pack(mu, A6, w, rgb if with_rgb else None).requires_grad_()
    ct = torch.tensor(rng.normal(size=(renders, 4 if with_rgb else 1, D, D,
                                       D)), dtype=torch.float32)
    out = aniso._render_plain(pk, z_lo, z_hi, D, with_rgb, "float32")
    want, = torch.autograd.grad((out * ct).sum(), pk)
    got = aniso.aniso_backward_reference(pk.detach(), z_lo, z_hi, ct, D,
                                         with_rgb)
    groups = [("mu", 0, 3), ("A6", 3, 9), ("w", 9, 10)]
    groups += [("rgb", 10, 13)] if with_rgb else []
    for label, a, b in groups:
        rel = _rel(got[:, a:b].numpy(), want[:, a:b].numpy())
        assert rel <= 1e-5, (label, rel)
    if not with_rgb:
        assert not got[:, 10:13].any()


def test_bf16_plain_backward_wiring(dpcx_results):
    """The CPU autograd.Function hands the cotangents to
    aniso_backward_reference unchanged and its forward is the plain bfloat16
    forward; no kernel launches on the CPU."""
    inputs, _ = dpcx_results
    inp = inputs["rgb"]
    mu, A6, w, rz = tgs.splat_params(
        *(torch.from_numpy(inp[k]) for k in ("points", "scales", "rot")), D,
        torch.from_numpy(inp["opacity"]))
    rgb = torch.from_numpy(inp["rgb"])
    ct = torch.randn(2, 4, D, D, D, generator=torch.Generator().manual_seed(3))
    x = [t.detach().requires_grad_() for t in (mu, A6, w, rgb)]
    dens, cols = aniso.aniso_density(*x, rz, D, "bfloat16")
    (torch.cat([dens[:, None], cols], 1) * ct).sum().backward()
    z_lo, z_hi = aniso.z_ranges(mu[..., 0], rz, D)
    pk = aniso.pack(mu, A6, w, rgb)
    dpk = aniso.aniso_backward_reference(pk, z_lo, z_hi, ct, D, True,
                                         "bfloat16")
    for t, (a, b) in zip(x, ((0, 3), (3, 9), (9, 10), (10, 13))):
        want = dpk[:, a:b].transpose(1, 2)
        torch.testing.assert_close(t.grad, want.reshape(t.shape), atol=0,
                                   rtol=0)
    d_ref, c_ref = aniso.aniso_density_reference(mu, A6, w, rgb, rz, D,
                                                 "bfloat16")
    torch.testing.assert_close(dens.detach(), d_ref, atol=0, rtol=0)
    torch.testing.assert_close(cols.detach(), c_ref, atol=0, rtol=0)
    assert not any(aniso.LAUNCHES.values())


def test_bf16_reference_refuses_autograd(dpcx_results):
    """Autograd through the bfloat16 plain forward would differentiate the
    rounded e, which is not K7's function: aniso_density_reference refuses
    inputs that require grad in that mode, takes them without grad, and
    keeps float32 differentiable."""
    inp = dpcx_results[0]["density"]
    mu, A6, w, rz = tgs.splat_params(
        *(torch.from_numpy(inp[k]) for k in ("points", "scales", "rot")), D,
        torch.from_numpy(inp["opacity"]))
    mu = mu.detach().requires_grad_()
    with pytest.raises(ValueError, match="aniso_density_plain"):
        aniso.aniso_density_reference(mu, A6, w, None, rz, D, "bfloat16")
    with torch.no_grad():
        dens = aniso.aniso_density_reference(mu, A6, w, None, rz, D,
                                             "bfloat16")
    assert torch.isfinite(dens).all()
    dens = aniso.aniso_density_reference(mu, A6, w, None, rz, D)
    assert dens.requires_grad


def _unflat(flat: dict, prefix: str) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        if key.startswith(prefix):
            *path, leaf = key[len(prefix):].split("/")
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = v
    return tree


def test_bf16_splat_train_step_matches_dpcx(dpcx_results, monkeypatch):
    """From dpcx's state after one float32 step (params and Adam moments
    carried across by convert.py), one rgb_splats step with
    pallas_acc_dtype bfloat16 at D 32: the port's loss and parameter update
    within SHARE of the distance between dpcx's bfloat16 and float32 steps
    from dpcx's bfloat16 step."""
    inputs, ref = dpcx_results
    step = inputs["step"]
    w = torch.from_numpy(step["w"])
    monkeypatch.setattr(tlosses, "pc_point_dropout_weights", lambda *a: w)
    cfg = TConfig(**STEP_CFG).replace(pallas_acc_dtype="bfloat16")
    state = ttrain.create_state(cfg, "cpu")
    warm = params_from_flax(_unflat(ref, "warm__params/"))
    state.model.load_state_dict(warm)
    state.load_adam_state(adam_state_from_optax(
        _unflat(ref, "warm__mu/"), _unflat(ref, "warm__nu/"),
        ref["warm__count"]))
    state.step = int(ref["warm__step"])
    batch = {k[len("b1__"):]: v for k, v in step.items()
             if k.startswith("b1__")}
    m = ttrain.train_step(cfg, state, ttrain._prep_batch(batch, "cpu", cfg),
                          prng.prng_key(1))
    loss = {acc: float(ref[f"step__{acc}__loss"])
            for acc in ("float32", "bfloat16")}
    _check("train step loss_total", abs(m["loss_total"].item()
                                        - loss["bfloat16"]),
           abs(loss["bfloat16"] - loss["float32"]),
           floor=1e-7 * loss["float32"])

    def update(params):
        return torch.cat([(params[k] - warm[k]).flatten() for k in warm])

    got = update(state.model.state_dict())
    want, f32 = (
        update(params_from_flax(_unflat(ref, f"step__{acc}__params/")))
        for acc in ("bfloat16", "float32"))
    norm = torch.linalg.vector_norm(want).item()
    _check("train step parameter update (relative L2)",
           torch.linalg.vector_norm(got - want).item() / norm,
           torch.linalg.vector_norm(want - f32).item() / norm)
