"""The frozen plain reference equals the port's CPU path at small sizes,
bit for bit, on the routes the cells run and their neighbours."""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from benchmark import harness, pipelines, scenes
from benchmark.reference import array as array_ref
from benchmark.reference import two_view as two_view_ref

KITTI = harness.load_json(harness.ROOT / "benchmark/configs/kitti2015_sgm.json")
ARRAY = harness.load_json(harness.ROOT / "benchmark/configs/array5x5_cross.json")


def _same(got, want):
    assert pipelines.mismatches(torch, got, want) == {k: 0 for k in want}


@pytest.mark.parametrize("h,w,D,dtype,paths,lr", [
    (20, 40, 16, "int16", 8, 1.25),
    (23, 51, 24, "int8", 8, 1.25),
    (17, 33, 12, "int16", 4, 0.0),
])
def test_two_view_reference_is_the_port(h, w, D, dtype, paths, lr):
    from stereovisionarray_tpu_torch.config import EngineConfig
    from stereovisionarray_tpu_torch.models import two_view_disparity

    engine = copy.deepcopy(KITTI["engine"])
    engine["cost"].update(num_disparities=D, dtype=dtype)
    engine["sgm"].update(num_paths=paths, lr_max_diff=lr)
    cfg = EngineConfig.from_dict(engine)
    left, right = (torch.from_numpy(a) for a in scenes.to_uint8(
        np.stack(scenes.large_range_pair(np.random.default_rng(D), h, w))))
    out = two_view_disparity(left, right, cfg.cost, cfg.sgm)
    got = {"disparity": out.disparity, "valid": out.valid, "cost": out.cost,
           "confidence": out.confidence}
    _same(got, two_view_ref.disparity(left, right, engine))


@pytest.mark.parametrize("topology,planes", [("CROSS", 16), ("to_center", 12)])
def test_array_reference_is_the_port(topology, planes):
    from stereovisionarray_tpu_torch.config import EngineConfig
    from stereovisionarray_tpu_torch.geometry.camera import camera_array_from_numpy
    from stereovisionarray_tpu_torch.models import array_depth_pipeline

    rig_cfg = dict(ARRAY["rig"], resolution=[27, 36])
    engine = copy.deepcopy(ARRAY["engine"])
    engine["camera"]["resolution"] = [27, 36]
    engine["plane_sweep"].update(topology=topology, num_planes=planes)
    rig = scenes.grid_rig(rig_cfg)
    images = scenes.to_uint8(scenes.render_rig(rig, 27, 36, seed=3)).numpy()
    cams = camera_array_from_numpy(*(rig[k] for k in ("fx", "fy", "cx", "cy", "R", "t")))
    out = array_depth_pipeline(torch.from_numpy(images).to(torch.float32), cams,
                               EngineConfig.from_dict(engine))
    want = array_ref.depth(torch.from_numpy(images), rig, engine)
    _same({"depth": out.depth, "refined_depth": out.refined_depth, "valid": out.valid}, want)
    assert want["valid"].any() and not torch.equal(want["depth"], want["refined_depth"])


def test_depth_samples_are_the_port():
    from stereovisionarray_tpu_torch.geometry.epipolar import inverse_depth_samples

    for num in (1, 16, 33, 128):
        assert np.array_equal(array_ref.inverse_depth_samples(0.55, 1.1, num),
                              inverse_depth_samples(0.55, 1.1, num))
