"""The port's own configuration tree equals the JAX package's field for field
(names, types, defaults), and a configuration carries across both ways
through ``to_dict`` / ``from_dict``."""

import dataclasses

import pytest

from stereovisionarray_tpu import config as jax_config
from stereovisionarray_tpu_torch import config

CLASSES = ("CameraArrayConfig", "CostConfig", "SGMConfig", "PlaneSweepConfig", "RefineConfig",
           "SfMConfig", "MeshConfig", "EngineConfig")


@pytest.mark.parametrize("name", CLASSES)
def test_fields_names_types_and_defaults_match(name):
    ours, theirs = getattr(config, name), getattr(jax_config, name)
    assert ours is not theirs and ours.__module__ == "stereovisionarray_tpu_torch.config"
    assert ours.__dataclass_params__.frozen and theirs.__dataclass_params__.frozen
    fa, fb = dataclasses.fields(ours), dataclasses.fields(theirs)
    assert [f.name for f in fa] == [f.name for f in fb]
    assert [str(f.type) for f in fa] == [str(f.type) for f in fb]
    assert dataclasses.asdict(ours()) == dataclasses.asdict(theirs())


def test_engine_config_carries_across_both_ways():
    jax_cfg = jax_config.EngineConfig().override(**{
        "sgm.p2": 80.0, "cost.census_window": (5, 7), "plane_sweep.cost": "zncc",
        "camera.resolution": (270, 360), "seed": 3})
    ours = config.EngineConfig.from_dict(jax_cfg.to_dict())
    assert isinstance(ours, config.EngineConfig) and isinstance(ours.sgm, config.SGMConfig)
    assert ours.to_dict() == jax_cfg.to_dict()
    assert ours.cost.census_window == (5, 7)  # lists from to_json come back as tuples
    assert config.EngineConfig.from_json(jax_cfg.to_json()) == ours
    assert jax_config.EngineConfig.from_dict(ours.to_dict()) == jax_cfg


def test_override_and_presets_match():
    ours = config.EngineConfig().override(**{"sgm.p1": 10.0, "refine.radius": 3})
    theirs = jax_config.EngineConfig().override(**{"sgm.p1": 10.0, "refine.radius": 3})
    assert ours.to_dict() == theirs.to_dict()
    with pytest.raises(KeyError):
        config.EngineConfig().override(**{"sgm.p3": 1.0})
    for a, b in zip(config.noise_robust_preset(), jax_config.noise_robust_preset()):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert config.CameraArrayConfig().pixel_size == jax_config.CameraArrayConfig().pixel_size
