"""dpcx_torch networks and model against dpcx's flax modules, with the
flax weights converted by ``dpcx_torch.convert.params_from_flax``.

Tolerances: at ``compute_dtype=float32`` atol 1e-5 (the same f32 convs and
matmuls summed in another order); at bfloat16 a mean abs error of at most
0.05, the serving-fidelity bound of tests/test_cli.py (the two frameworks
round bf16 at different places).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpcx.config import Config
from dpcx.models.model_pc import ModelPointCloud as JModel
from dpcx.nets.img_encoder import ImageEncoder as JEncoder
from dpcx.nets.pc_decoder import PointCloudDecoder as JDecoder
from dpcx_torch.config import Config as TConfig
from dpcx_torch.convert import params_from_flax
from dpcx_torch.models.model_pc import ModelPointCloud
from dpcx_torch.nets import net_factory
from dpcx_torch.nets.layers import same_pads

ATOL = 1e-5


def _t(cfg: Config) -> TConfig:
    """The port's Config with the same fields as dpcx's."""
    return TConfig(**dataclasses.asdict(cfg))


def _cfg(image_size=16, dtype="float32", **kw):
    return Config(
        image_size=image_size, encoder_filters=(8, 16), latent_dim=24,
        fc_hidden=32, pc_decoder_hidden=(32, 32), pc_num_points=40,
        compute_dtype=dtype, **kw,
    )


def _flax_params(cfg):
    dummy = jnp.zeros((1, cfg.image_size, cfg.image_size, 3))
    params = JModel(cfg).init(jax.random.PRNGKey(1), dummy)
    return jax.tree.map(np.asarray, params)


def _torch_model(cfg, flax_params):
    model = ModelPointCloud(_t(cfg))
    model.load_state_dict(params_from_flax(flax_params))  # strict
    return model.eval()


def _images(rng, cfg, b=3):
    return rng.random((b, cfg.image_size, cfg.image_size, 3), np.float32)


def test_converter_covers_every_parameter():
    cfg = _cfg()
    sd = params_from_flax(_flax_params(cfg))
    model_sd = ModelPointCloud(_t(cfg)).state_dict()
    assert sd.keys() == model_sd.keys()
    for k, v in sd.items():
        assert v.shape == model_sd[k].shape, k
        assert v.dtype == torch.float32
    assert "encoder.fc_pose.weight" in sd  # present without predict_pose
    # the tree may come with or without the top-level "params" key
    bare = params_from_flax(_flax_params(cfg)["params"])
    assert bare.keys() == sd.keys()


@pytest.mark.parametrize("image_size", [16, 13])  # even and odd SAME pads
def test_encoder_matches_flax(image_size, rng):
    cfg = _cfg(image_size)
    fp = _flax_params(cfg)
    model = _torch_model(cfg, fp)
    imgs = _images(rng, cfg)
    enc_j = JEncoder(
        filters=cfg.encoder_filters, latent_dim=cfg.latent_dim,
        fc_hidden=cfg.fc_hidden, compute_dtype=jnp.float32,
    ).apply({"params": fp["params"]["encoder"]}, jnp.asarray(imgs))
    with torch.no_grad():
        enc_t = model.encoder(torch.from_numpy(imgs))
    for k in ("latent", "pose_inp"):
        assert enc_t[k].dtype == torch.float32
        np.testing.assert_allclose(enc_t[k].numpy(), np.asarray(enc_j[k]),
                                   atol=ATOL)


def test_decoder_matches_flax(rng):
    cfg = _cfg()
    fp = _flax_params(cfg)
    model = _torch_model(cfg, fp)
    latent = rng.normal(size=(3, cfg.latent_dim)).astype(np.float32)
    dec_j = JDecoder(
        num_points=cfg.pc_num_points, hidden=cfg.pc_decoder_hidden,
        compute_dtype=jnp.float32,
    ).apply({"params": fp["params"]["decoder"]}, jnp.asarray(latent))
    with torch.no_grad():
        dec_t = model.decoder(torch.from_numpy(latent))
    assert dec_t["points"].shape == (3, cfg.pc_num_points, 3)
    for k in ("points", "scale"):
        np.testing.assert_allclose(dec_t[k].numpy(), np.asarray(dec_j[k]),
                                   atol=ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("predict_scale", [True, False])
def test_model_matches_flax(dtype, predict_scale, rng):
    cfg = _cfg(dtype=dtype, predict_scale=predict_scale)
    fp = _flax_params(cfg)
    model = _torch_model(cfg, fp)
    imgs = _images(rng, cfg, b=4)
    out_j = JModel(cfg).apply(fp, jnp.asarray(imgs))
    with torch.no_grad():
        out_t = model(torch.from_numpy(imgs))
    assert out_t.keys() == set(out_j)
    for k in out_t:
        got, want = out_t[k].numpy(), np.asarray(out_j[k])
        assert got.dtype == want.dtype == np.float32
        if dtype == "float32":
            np.testing.assert_allclose(got, want, atol=ATOL)
        else:
            assert float(np.abs(got - want).mean()) <= 0.05, k


def test_seeded_init_follows_flax_defaults():
    """lecun_normal kernels (truncated at 2 std, fan-in scaled), zero
    biases; the same seed gives the same parameters."""
    cfg = Config(image_size=32, encoder_filters=(8,), latent_dim=256,
                 fc_hidden=512, pc_decoder_hidden=(256,), pc_num_points=64)
    tcfg = _t(cfg)
    m1 = ModelPointCloud(tcfg, generator=torch.Generator().manual_seed(5))
    m2 = ModelPointCloud(tcfg, generator=torch.Generator().manual_seed(5))
    m3 = ModelPointCloud(tcfg)  # seeded from cfg.seed
    m4 = ModelPointCloud(tcfg)
    for (k, a), b in zip(m1.state_dict().items(), m2.state_dict().values()):
        assert torch.equal(a, b), k
    for a, b in zip(m3.state_dict().values(), m4.state_dict().values()):
        assert torch.equal(a, b)
    fp = _flax_params(cfg)["params"]
    w = m1.encoder.fc1.weight.detach()  # [512, 16*16*8]
    fan_in = w.shape[1]
    bound = 2.0 * np.sqrt(1.0 / fan_in) / 0.87962566103423978
    assert float(w.abs().max()) <= bound + 1e-6
    np.testing.assert_allclose(float(w.std()),
                               float(fp["encoder"]["fc1"]["kernel"].std()),
                               rtol=0.02)
    assert not m1.encoder.fc1.bias.any()
    np.testing.assert_allclose(float(w.std()), np.sqrt(1.0 / fan_in),
                               rtol=0.02)


@pytest.mark.parametrize("size", [7, 8, 13, 16, 128])
def test_same_pads_match_flax(size):
    """(lo, hi) pads give flax's SAME output size and its asymmetric
    split: stride 2 on an even input pads (0, 1)."""
    lo, hi = same_pads(size, 3, 2)
    assert (size + lo + hi - 3) // 2 + 1 == -(-size // 2)
    assert hi - lo in (0, 1)
    if size % 2 == 0:
        assert (lo, hi) == (0, 1)


def test_registry_and_unported_heads():
    assert net_factory.get_network("img_encoder").__name__ == "ImageEncoder"
    assert net_factory.get_network("pc_decoder").__name__ == \
        "PointCloudDecoder"
    with pytest.raises(KeyError, match="pose_head"):
        net_factory.get_network("pose_head")
    with pytest.raises(NotImplementedError, match="pose"):
        ModelPointCloud(_t(_cfg(predict_pose=True)))


@pytest.mark.parametrize("heads", [{"pc_rgb": True}, {"pc_gauss": True},
                                   {"pc_rgb": True, "pc_gauss": True,
                                    "gauss_scale_min": 0.01,
                                    "gauss_scale_max": 0.05}])
def test_rgb_and_gauss_heads_match_flax(heads, rng):
    """The decoder's rgb (sigmoid) and gauss heads (bounded scales,
    identity-biased unit quaternion, sigmoid opacity) through
    params_from_flax, whose strict load maps decoder/fc_rgb and
    decoder/fc_gauss."""
    cfg = _cfg(**heads)
    fp = _flax_params(cfg)
    sd = params_from_flax(fp)
    for name in (["decoder.fc_rgb.weight"] if cfg.pc_rgb else []) + (
            ["decoder.fc_gauss.weight"] if cfg.pc_gauss else []):
        width = 3 if "rgb" in name else 8
        assert sd[name].shape == (width * cfg.pc_num_points,
                                  cfg.pc_decoder_hidden[-1]), name
    model = _torch_model(cfg, fp)  # strict load_state_dict
    imgs = _images(rng, cfg, b=4)
    out_j = JModel(cfg).apply(fp, jnp.asarray(imgs))
    with torch.no_grad():
        out_t = model(torch.from_numpy(imgs))
    assert out_t.keys() == set(out_j)
    assert ("rgb" in out_t) == cfg.pc_rgb
    assert ("gauss_rot" in out_t) == cfg.pc_gauss
    for k in out_t:
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]),
                                   atol=ATOL, err_msg=k)
    if cfg.pc_gauss:
        s = out_t["gauss_scales"]
        assert ((s > cfg.gauss_scale_min) & (s < cfg.gauss_scale_max)).all()
        torch.testing.assert_close(
            torch.linalg.vector_norm(out_t["gauss_rot"], dim=-1),
            torch.ones(4, cfg.pc_num_points))
