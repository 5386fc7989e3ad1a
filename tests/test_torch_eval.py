"""The port's eval metrics against dpcx's (CPU): voxel IoU, the pose error
metrics, the canonical-frame alignment, and the Chamfer distance's row
groups.

Tolerances:
- ``_occupancy`` and ``voxel_iou`` on identical points: exact (the same
  f32 grid mapping, both rounding half to even);
- the pose error metrics: rtol 1e-5 (the same f32 arccos of dots summed
  in another order); the per-sample errors also atol 3e-4 degrees, where
  the arccos of a dot near 1 magnifies an ulp;
- ``align_canonical_frame``: q_align within 1e-5 of dpcx's, up to sign
  (the same grid and candidates; only the means' sum order differs), or
  a tie: a pick whose mean error lies within f32's noise of dpcx's;
- the rotation grid and the axis sphere: atol 1e-6 (f32 sin/cos of two
  libraries).

``chip_smoke.py``'s card-against-CPU hold of ``evaluate`` (phase 9e) is
run here on the CPU on a planted tie of the re-alignment's argmin.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpcx.eval import iou as j_iou
from dpcx.eval import pose_metrics as j_pm
from dpcx.geometry.quaternion import quaternion_angular_distance as j_ad
from dpcx.geometry.quaternion import quaternion_multiply as j_qmul
import chip_smoke
from dpcx_torch import predict
from dpcx_torch.eval import chamfer, iou, pose_metrics
from dpcx_torch.eval.chamfer import chamfer_distance
from dpcx_torch.geometry.quaternion import (
    quaternion_conjugate,
    quaternion_multiply,
)
from torch_workers import share_cores

share_cores()


def _unit(rng, shape):
    q = rng.normal(size=shape + (4,)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _iou_points(rng, B, N, D):
    """Clouds with a third of the points exactly on a .5 cell boundary of
    one axis or more, a tenth outside the box, the rest anywhere."""
    pts = rng.uniform(-0.5, 0.5, (B, N, 3))
    k = N // 3
    cell = rng.integers(-1, D, (B, k, 3)) + 0.5  # g = i + 0.5
    on_edge = (cell + 0.5) / D - 0.5  # exact in f32 for these D
    mask = rng.random((B, k, 3)) < 0.6
    pts[:, :k] = np.where(mask, on_edge, pts[:, :k])
    out = N // 10
    pts[:, -out:] = rng.uniform(0.5, 0.7, (B, out, 3)) * rng.choice(
        [-1.0, 1.0], (B, out, 3))
    return pts.astype(np.float32)


@pytest.mark.parametrize("D", [8, 16, 32])
def test_voxel_iou_and_occupancy_exact(D):
    """Nearest-cell occupancy and the IoU equal dpcx's bit for bit, with
    points on .5 cell boundaries (half to even) and outside the box."""
    rng = np.random.default_rng(D)
    pred = _iou_points(rng, 3, 300, D)
    gt = np.concatenate([pred[:, :200], _iou_points(rng, 3, 200, D)], 1)
    g = (pred[..., ::-1] + 0.5) * D - 0.5
    assert (np.abs(g - np.round(g)) == 0.5).any()  # ties are present
    assert ((g < -0.5) | (g > D - 0.5)).any()  # so are dropped points
    occ_t = iou._occupancy(torch.from_numpy(pred), D).numpy()
    occ_j = np.asarray(j_iou._occupancy(jnp.asarray(pred), D))
    np.testing.assert_array_equal(occ_t, occ_j)
    assert occ_t.any()
    got = iou.voxel_iou(torch.from_numpy(pred), torch.from_numpy(gt), D)
    want = np.asarray(j_iou.voxel_iou(jnp.asarray(pred), jnp.asarray(gt), D))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.0 < want.min() and want.max() < 1.0


def test_median_of_an_even_count_is_the_mean_of_the_middles():
    """jnp.median averages the two middle values; torch.median would take
    the lower one."""
    x = torch.tensor([4.0, 1.0, 3.0, 10.0])
    assert float(pose_metrics._median(x)) == 3.5
    assert float(torch.median(x)) == 3.0
    assert float(np.asarray(jnp.median(jnp.asarray(x.numpy())))) == 3.5
    assert float(pose_metrics._median(torch.tensor([5.0, 1.0, 2.0]))) == 2.0


@pytest.mark.parametrize("M", [10, 9])
def test_pose_error_metrics_match_dpcx(M):
    """Both metric sets on an even (the median between two values) and an
    odd count; a third of the samples sit 180 degrees about y from gt."""
    rng = np.random.default_rng(M)
    gt = _unit(rng, (M,))
    pred = _unit(rng, (M,))
    near = (gt + 0.05 * rng.normal(size=gt.shape)).astype(np.float32)
    pred[: M // 3] = near[: M // 3]
    flip = np.asarray(j_qmul(jnp.asarray(near), j_pm.FLIP_QUAT[None]))
    pred[M // 3: 2 * M // 3] = flip[M // 3: 2 * M // 3]
    t = {k: v.numpy() for k, v in pose_metrics.pose_error_metrics(
        torch.from_numpy(pred), torch.from_numpy(gt)).items()}
    j = j_pm.pose_error_metrics(jnp.asarray(pred), jnp.asarray(gt))
    assert list(t) == list(j)
    for k in ("acc_30deg", "median_err_deg"):
        np.testing.assert_allclose(t[k], np.asarray(j[k]), rtol=1e-5,
                                   err_msg=k)
    # per sample, arccos near a dot of 1 magnifies one f32 ulp of the dot
    # (summed in another order) to ~1.6e-4 degrees at 5 degrees
    np.testing.assert_allclose(t["angular_err_deg"],
                               np.asarray(j["angular_err_deg"]), rtol=1e-5,
                               atol=3e-4)
    t = pose_metrics.pose_error_metrics_up_to_flip(
        torch.from_numpy(pred), torch.from_numpy(gt))
    j = j_pm.pose_error_metrics_up_to_flip(jnp.asarray(pred),
                                           jnp.asarray(gt))
    assert list(t) == list(j)
    for k in t:
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]),
                                   rtol=1e-5, err_msg=k)
    assert 0.0 < float(t["flip_rate"]) < 1.0
    np.testing.assert_array_equal(pose_metrics.FLIP_QUAT.numpy(),
                                  np.asarray(j_pm.FLIP_QUAT))


@pytest.mark.parametrize("n", [512, 2048])
def test_rotation_grid_and_axis_sphere_match_dpcx(n):
    np.testing.assert_allclose(pose_metrics._rotation_grid(n).numpy(),
                               np.asarray(j_pm._rotation_grid(n)), atol=1e-6)
    np.testing.assert_allclose(pose_metrics._axis_sphere(48).numpy(),
                               np.asarray(j_pm._axis_sphere(48)), atol=1e-6)


@pytest.mark.parametrize("seed,M,noise", [
    (0, 16, 0.02),  # a tie in the last refinement round (0.1 degrees)
    (1, 30, 0.05), (2, 8, 0.0), (3, 16, 0.02), (5, 40, 0.1),
])
def test_align_canonical_frame_matches_dpcx(seed, M, noise):
    """pred = gt o conj(a) plus noise: both find the same q_align within
    1e-5, up to sign, or two whose mean errors f32 cannot tell apart (the
    argmin over candidates whose errors are summed in another order); and
    it lies near a."""
    rng = np.random.default_rng(seed)
    gt = _unit(rng, (M,))
    a = _unit(rng, ())
    pred = np.asarray(j_qmul(jnp.asarray(gt), jnp.asarray(a * [1, -1, -1, -1],
                                                         jnp.float32)))
    pred = pred + noise * rng.normal(size=pred.shape)
    pred = (pred / np.linalg.norm(pred, axis=-1, keepdims=True)).astype(
        np.float32)
    q_t, al_t = pose_metrics.align_canonical_frame(torch.from_numpy(pred),
                                                   torch.from_numpy(gt))
    q_j, al_j = j_pm.align_canonical_frame(jnp.asarray(pred),
                                           jnp.asarray(gt))
    q_t, q_j = q_t.numpy(), np.asarray(q_j)
    sign = np.sign(np.dot(q_t, q_j))
    if np.abs(sign * q_t - q_j).max() > 1e-5:
        # a tie: the mean errors (dpcx's own) of the two picks lie closer
        # than that of one q and its neighbour one f32 ulp away (~4e-7
        # rad, measured), so f32 cannot order them
        def mean_err(q):
            al = j_qmul(jnp.asarray(pred), jnp.asarray(q)[None])
            return float(jnp.mean(j_ad(al, jnp.asarray(gt))))

        assert abs(mean_err(q_t) - mean_err(q_j)) < 5e-7, (q_t, q_j)
    else:
        np.testing.assert_allclose(sign * al_t.numpy(), np.asarray(al_j),
                                   atol=1e-5)
    # the truth, to within the grid search's residual (<0.5 degrees) or,
    # with noise, the shift it gives the mean error's minimum
    off = np.degrees(2 * np.arccos(min(abs(float(np.dot(q_t, a))), 1.0)))
    assert off < (0.5 if noise == 0 else 5.0), off


def test_chamfer_row_groups_hold_the_budget(monkeypatch):
    """directed_distance takes the rows in groups of at most
    ROW_BUDGET bytes a tensor: with a budget of one row a pass, the same
    numbers as one group of all rows, and no pass sees more than one."""
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.uniform(-0.5, 0.5, (2, 3, 40, 3)).astype(
        np.float32))
    b = torch.from_numpy(rng.uniform(-0.5, 0.5, (2, 3, 50, 3)).astype(
        np.float32))
    whole = chamfer_distance(a, b, chunk=16)
    seen = []
    rows_fn = chamfer._directed_rows

    def spy(a_, b_, chunk_):
        seen.append(a_.shape[0])
        return rows_fn(a_, b_, chunk_)

    monkeypatch.setattr(chamfer, "_directed_rows", spy)
    monkeypatch.setattr(chamfer, "ROW_BUDGET", 50 * 16 * 4)  # one gt->pred row
    parts = chamfer_distance(a, b, chunk=16)
    assert seen == [1] * 6 + [1] * 6, seen
    for k in whole:
        assert parts[k].shape == (2, 3)
        torch.testing.assert_close(parts[k], whole[k], atol=0, rtol=0)
    seen.clear()
    monkeypatch.setattr(chamfer, "ROW_BUDGET", 2 * 40 * 16 * 4)
    chamfer.directed_distance(a, b, chunk=16)
    assert seen == [2, 2, 2], seen


def _rz(deg: float) -> np.ndarray:
    h = np.radians(deg) / 2
    return np.array([np.cos(h), 0.0, 0.0, np.sin(h)])


def test_eval_hold_explains_a_realignment_tie(monkeypatch):
    """chip_smoke.py's hold of the card's `evaluate` against the CPU's
    (hold_eval_metrics) on a planted tie of the re-alignment alone, every
    side on the CPU. Eight poses about z against identity GTs: seven at
    -170, -160, -150, 0, 20, 25 and 35 degrees, and one at 0.3 degrees
    composed with the inverse of the 180-degree flip, which the flip
    correction brings back. A "card" whose poses differ by f32 noise (5e-7)
    makes the same canonical pick, but its re-alignment picks a rotation
    ~0.6 degrees away at a mean error the CPU's lies within 1e-6 of (a
    tie), so the up-to-flip median misses the CPU's. The CPU's metrics at
    the card's two picks (metrics_at_pick) give the card's, and the hold
    passes; the CPU's own picks give `evaluate`'s CPU metrics bit for bit.
    Controls: the card's median moved off its picks' value by 3e-5, or the
    re-alignment's picks made one, fail."""
    monkeypatch.setattr(predict, "load_model",
                        lambda cfg, params: torch.nn.Linear(1, 1))
    rng = np.random.default_rng(0)
    gt_points = rng.uniform(-0.5, 0.5, (8, 64, 3)).astype(np.float32)
    points = rng.uniform(-0.5, 0.5, (8, 64, 3)).astype(np.float32)
    gq = np.tile(np.float32([1, 0, 0, 0]), (8, 1))
    flip_inv = quaternion_conjugate(pose_metrics.FLIP_QUAT.double())
    pose = np.stack(
        [_rz(t) for t in (-170, -160, -150, 0, 20, 25, 35)]
        + [quaternion_multiply(torch.from_numpy(_rz(0.3)), flip_inv).numpy()]
    ).astype(np.float32)

    def evaluate(p):
        pred = {"pose": p, "points": points}
        monkeypatch.setattr(predict, "predict_dataset", lambda *a: pred)
        ds = SimpleNamespace(records={"gt_points": gt_points,
                                      "quats": gq[:, None]},
                             num_views=1, num_models=8)
        return predict.evaluate(None, None, ds), pred

    want, p_cpu = evaluate(pose)
    q_own = chip_smoke.alignment_tie(pose, pose, gq, "cpu")[2]
    q2_own = chip_smoke.realignment_tie(pose, pose, gq, "cpu")[2]
    assert chip_smoke.metrics_at_pick(p_cpu, q_own, q2_own, gt_points,
                                      gq) == want
    ties = 0
    for seed in range(40):
        card = (pose + 5e-7 * np.random.default_rng(seed).standard_normal(
            pose.shape)).astype(np.float32)
        canonical = chip_smoke.alignment_tie(pose, card, gq, "cpu")
        realign = chip_smoke.realignment_tie(pose, card, gq, "cpu")
        if realign[0] <= chip_smoke.TIE_MIN_DEG:
            continue
        got, _ = evaluate(card)
        at_pick = chip_smoke.metrics_at_pick(p_cpu, canonical[2], realign[2],
                                             gt_points, gq)
        assert canonical[0] <= chip_smoke.TIE_MIN_DEG, canonical
        assert chip_smoke.is_tie(*realign[:2]), realign
        assert chip_smoke.hold_eval_metrics(
            got, want, at_pick, canonical[:2], realign[:2]) == [
                "pose_median_err_deg_up_to_flip"]
        k = "pose_median_err_deg_up_to_flip"
        moved = dict(got, **{k: at_pick[k] * (1 + 3e-5)})
        with pytest.raises(AssertionError):
            chip_smoke.hold_eval_metrics(moved, want, at_pick, canonical[:2],
                                         realign[:2])
        with pytest.raises(AssertionError):
            chip_smoke.hold_eval_metrics(got, want, at_pick, canonical[:2],
                                         (0.0, 0.0))
        ties += 1
        if ties == 2:
            break
    assert ties == 2
