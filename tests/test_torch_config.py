"""The port's own ``Config`` (``dpcx_torch/config.py``) pinned to dpcx's
(``dpcx/config.py``), so that the copy cannot drift: the same fields, types
and defaults, the same configs from every experiment YAML, the same
``validate()`` messages, and YAML files each package reads back from the
other.
"""

import dataclasses
from pathlib import Path

import pytest

import dpcx.config as jconfig
import dpcx_torch.config as tconfig

EXPERIMENTS = sorted(
    (Path(__file__).resolve().parent.parent / "experiments").glob("*.yaml")
)


def _default(f: dataclasses.Field):
    if f.default_factory is not dataclasses.MISSING:
        return f.default_factory()
    return f.default


def test_fields_types_and_defaults_match_dpcx():
    j = dataclasses.fields(jconfig.Config)
    t = dataclasses.fields(tconfig.Config)
    assert [f.name for f in t] == [f.name for f in j]
    for a, b in zip(t, j):
        assert (a.type, _default(a)) == (b.type, _default(b)), a.name
    assert tconfig._TUPLE_FIELDS == jconfig._TUPLE_FIELDS
    assert tconfig.Config().effective_mask_size == 64
    assert tconfig.Config.__dataclass_params__.frozen


@pytest.mark.parametrize("path", EXPERIMENTS, ids=lambda p: p.stem)
def test_experiment_yamls_load_equal(path):
    t = tconfig.load_config(path)
    assert isinstance(t, tconfig.Config)
    assert dataclasses.asdict(t) == dataclasses.asdict(jconfig.load_config(path))


# contradictory knob sets: validate() must reject each with dpcx's message
CONTRADICTIONS = [
    {"pose_from_views": True},
    {"predict_translation": True, "pose_anchor_weight": 0.5},
    {"renderer": "tpu", "texture_mode": "plaid"},
    {"shard_points": True, "predict_pose": True},
    {"shard_points": True, "pc_gauss": True},
    {"predict_pose": True, "pose_consistency_weight": 1.0, "num_views": 1},
    {"predict_pose": True, "gauge_reseed_threshold_deg": 20.0},
]


@pytest.mark.parametrize("overrides", CONTRADICTIONS)
def test_validate_messages_match_dpcx(overrides):
    with pytest.raises(ValueError) as want:
        jconfig.Config(**overrides).validate()
    with pytest.raises(ValueError) as got:
        tconfig.Config(**overrides).validate()
    assert str(got.value) == str(want.value)


def test_load_and_save_match_dpcx(tmp_path):
    for mod in (jconfig, tconfig):
        with pytest.raises(ValueError, match=r"Unknown config keys: \['nope'\]"):
            mod.load_config(None, nope=1)
    cfg = tconfig.load_config(EXPERIMENTS[0], vox_size=40,
                              encoder_filters=[8, 16])
    assert cfg.encoder_filters == (8, 16)
    tconfig.save_config(cfg, tmp_path / "t.yaml")
    jconfig.save_config(jconfig.Config(**dataclasses.asdict(cfg)),
                        tmp_path / "j.yaml")
    assert (tmp_path / "t.yaml").read_text() == \
        (tmp_path / "j.yaml").read_text()
    back = jconfig.load_config(tmp_path / "t.yaml")
    assert dataclasses.asdict(back) == dataclasses.asdict(cfg)
    assert tconfig.Config().validate() == tconfig.Config()
