"""The frozen yardstick: hand counts at small shapes, and the bound equal to
the port's ``render_bound`` at the cells' shapes, its numbers pinned."""

from __future__ import annotations

import pytest

from benchmark import yardstick as y

# (renders, points, D, radius, depth, point weights, backward) -> (ms, by)
# at the cells' shapes: car_64_depth's training step (1,024 renders with
# dropout weights), multicat_128_fused's (256 at D 128), the render cell
CELL_BOUNDS = {
    (1024, 16000, 64, 8, True, True, False): (0.4274590490746269,
                                              "operations"),
    (1024, 16000, 64, 8, True, True, True): (0.4870400967164179, "bytes"),
    (256, 16000, 128, 16, False, True, False): (1.5349313719402984,
                                                "operations"),
    (256, 16000, 128, 16, False, True, True): (1.603192495761194,
                                               "operations"),
    (1024, 16000, 64, 8, True, False, False): (0.4274590490746269,
                                               "operations"),
    (1024, 16000, 64, 8, True, False, True): (0.47613958113432836,
                                              "operations"),
}


def test_blur_taps_by_hand():
    # a line of 4 cells, radius 1: 2 + 3 + 3 + 2 taps in range
    assert y.blur_taps(4, 1) == 10
    assert y.blur_taps(5, 0) == 5


def test_forward_work_by_hand():
    # 1 render, 2 points, D 4, radius 1, no depth, no weights: splat 40 a
    # point, 3 blur passes of 2 x 16 lines x 10 taps, DRC 6 a cell; bytes:
    # 2 points x 3 floats, 3 taps, a 4 x 4 image
    w = y.render_work(1, 2, 4, 1, False, False, backward=False)
    assert (w["mm_ops"], w["f32_ops"], w["bytes"]) == (
        40 * 2 + 3 * 320, 6 * 64, 4 * (2 * 3 + 3 + 16))
    # 100 B at 3.35 TB/s take longer than 1424 operations at 67 TFLOP/s
    assert w["seconds"] == pytest.approx(100 / 3.35e12)
    assert w["by"] == "bytes"


def test_backward_takes_the_lesser_way():
    # the saved grid's bytes (4 a cell) against redoing splat and blur
    read = y._way(3 * 320 + 108 * 2, 14 * 64, 2 * 24 + 12 + 64 + 4 * 64,
                  False)
    redo = y._way(3 * 320 + 108 * 2 + 40 * 2 + 3 * 320, 14 * 64,
                  2 * 24 + 12 + 64, False)
    w = y.render_work(1, 2, 4, 1, False, False, backward=True)
    assert w["seconds"] == min(read["seconds"], redo["seconds"])


def test_model_ops_by_hand():
    cfg = {"image_size": 32, "encoder_filters": [8, 16], "fc_hidden": 64,
           "latent_dim": 64, "pc_decoder_hidden": [64],
           "pc_num_points": 256}
    conv0 = 2 * 16 * 16 * 8 * 3 * 9
    conv1 = 2 * 8 * 8 * 16 * 8 * 9
    dense = 2 * (1024 * 64 + 64 * 64 + 64 * 64 + 64 * 768 + 64 * 1)
    assert y.model_forward_ops(cfg) == (conv0 + conv1 + dense, conv0)
    assert y.model_train_ops(cfg, 2) == 2 * (3 * (conv0 + conv1 + dense)
                                             - conv0)


@pytest.mark.parametrize("args", sorted(CELL_BOUNDS))
def test_bound_pinned_and_equal_to_the_port(args):
    from dpcx_torch.bench import render_bound

    w = y.render_work(*args)
    assert (w["seconds"] * 1e3, w["by"]) == CELL_BOUNDS[args]
    assert render_bound(*args) == CELL_BOUNDS[args]


def test_step_work_sums_forward_and_backward():
    cfg = {"pc_num_points": 16000, "vox_size": 64, "pc_relative_sigma": 0.05,
           "pc_relative_sigma_end": 0.016, "gauss_kernel_truncate": 2.5,
           "proj_depth": True, "pallas_acc_dtype": "float32"}
    assert y.kernel_radius(cfg) == 8
    w = y.render_step_work(cfg, 256, True)
    assert w["seconds"] * 1e3 == pytest.approx(0.10686476226865672
                                               + 0.12176003940298508)
