"""The port's default array deployment, ``benchmark/configs/array5x5_tocenter.json``
read from disk (24 sources, the mean of the 6 best, one refinement pass of
radius 5 over all 24 views by the hat blend), held against the benchmark's
frozen plain reference (``benchmark/reference/array.py``) bit for bit, on the
CPU (no JAX, no card): through ``array_depth_pipeline`` and through the
served path the cell runs, ``stream_depth_maps`` with uint8 transfer.

The frame is cut to 27x36 and the planes to 12, nothing else: at that size
the outer views leave the frame at the near planes, so the sweep's in-view
mask and the ceiling it puts on the views outside are exercised; a corner
pixel keeps 8 sources in view, as at full size.
"""

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import scenes
from benchmark.reference import array as frozen
from stereovisionarray_tpu_torch.config import EngineConfig
from stereovisionarray_tpu_torch.geometry.camera import camera_array_from_numpy
from stereovisionarray_tpu_torch.models import array_depth_pipeline
from stereovisionarray_tpu_torch.models.serving import stream_depth_maps
from stereovisionarray_tpu_torch.ops import refine

CONFIG = Path(__file__).resolve().parents[1] / "benchmark" / "configs" / "array5x5_tocenter.json"
RES, PLANES = [27, 36], 12
MAPS = ("depth", "refined_depth", "valid")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this file runs (the suite runs several
    workers on the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def deployment():
    """(engine dict cut to size, rig, cameras, two uint8 frame-sets, the
    reference's maps of each)."""
    conf = json.loads(CONFIG.read_text())
    engine = copy.deepcopy(conf["engine"])
    engine["camera"]["resolution"] = RES
    engine["plane_sweep"]["num_planes"] = PLANES
    rig = scenes.grid_rig(dict(conf["rig"], resolution=RES))
    base = scenes.render_rig(rig, *RES, seed=5)
    gen = torch.Generator().manual_seed(7)
    sets = [scenes.to_uint8(base + conf["noise"] * torch.randn(base.shape, generator=gen))
            .numpy() for _ in range(2)]
    cams = camera_array_from_numpy(*(rig[k] for k in ("fx", "fy", "cx", "cy", "R", "t")))
    want = [frozen.depth(torch.from_numpy(s), rig, engine) for s in sets]
    return engine, rig, cams, sets, want


def _same(got, want):
    for k in MAPS:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def test_configuration_is_the_port_default(deployment):
    """Topology, fusion, top-k and the refinement are EngineConfig()'s."""
    engine = deployment[0]
    cfg, default = EngineConfig.from_dict(engine), EngineConfig()
    for k in ("topology", "fusion", "topk", "cost", "patch"):
        assert getattr(cfg.plane_sweep, k) == getattr(default.plane_sweep, k), k
    assert cfg.refine == default.refine
    assert json.loads(CONFIG.read_text())["reduced"] == []


def test_route_is_top6_of_24_and_hat_blend(deployment):
    """24 sources fused by their 6 best, outer views out of the frame at
    the near planes (8 left in view at a corner), and a refinement plan with no integer candidate
    spacing (the hat blend)."""
    engine, rig, _, sets, _ = deployment
    ref_i, src = frozen.reference_and_sources(5, 5, engine["plane_sweep"]["topology"])
    assert (ref_i, len(src)) == (12, 24) and engine["plane_sweep"]["topk"] == 6
    depths = frozen.inverse_depth_samples(engine["plane_sweep"]["z_near"],
                                          engine["plane_sweep"]["z_far"], PLANES)
    sh = torch.from_numpy(frozen.shifts(rig, ref_i, src, depths)).transpose(0, 1).contiguous()
    images = torch.from_numpy(sets[0]).to(torch.float32)
    _, nv = frozen.sweep_volume(images[ref_i], torch.stack([images[i] for i in src]), sh,
                                engine["plane_sweep"]["patch"], "topk_mean", 6)
    assert int(nv.min()) == 8 and int(nv.max()) == 24
    bl, _ = frozen.baselines(rig, ref_i, src)
    rf = engine["refine"]
    plan = refine.stack_plan(bl, rf["radius"], rf["step"], 40.0)
    assert plan.q is None


def test_pipeline_is_the_reference(deployment):
    engine, _, cams, sets, want = deployment
    cfg = EngineConfig.from_dict(engine)
    for s, w in zip(sets, want):
        out = array_depth_pipeline(torch.from_numpy(s).to(torch.float32), cams, cfg)
        _same({k: getattr(out, k) for k in MAPS}, w)
    assert want[0]["valid"].any() and not torch.equal(want[0]["depth"],
                                                      want[0]["refined_depth"])


def test_served_path_is_the_reference(deployment):
    """The cell's path: frame-sets through stream_depth_maps, copied as
    uint8, two in flight."""
    engine, _, cams, sets, want = deployment
    outs = list(stream_depth_maps(iter(sets), cams, EngineConfig.from_dict(engine), depth=2,
                                  transfer_dtype=np.uint8, device="cpu"))
    assert [r.index for r in outs] == [0, 1]
    for r, w in zip(outs, want):
        _same({k: getattr(r.output, k) for k in MAPS}, w)
