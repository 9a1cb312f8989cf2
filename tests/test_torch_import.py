"""The PyTorch port stands alone: it never imports JAX, its backend follows the
tensor's device, and its penalty scaling matches the reference's."""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import pytest
import torch

from stereovisionarray_tpu.config import CostConfig, SGMConfig
from stereovisionarray_tpu.ops.cost_volume import cost_scale_for as jax_cost_scale_for
from stereovisionarray_tpu.ops.cost_volume import int8_cost_fits as jax_int8_cost_fits
from stereovisionarray_tpu_torch.backend import resolve_backend
from stereovisionarray_tpu_torch.models.two_view import scaled_penalties

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "stereovisionarray_tpu_torch"


def test_importing_every_module_leaves_jax_out():
    code = (
        "import importlib, pkgutil, sys\n"
        "import stereovisionarray_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'stereovisionarray_tpu' or m.startswith('stereovisionarray_tpu.'))\n"
        "print(len(bad), bad[:5])\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


ARRAY_SLICE_MODULES = (
    "geometry.camera", "geometry.epipolar", "geometry.topology", "datasets.synthetic",
    "ops.warp", "ops.sweep_cuda", "ops.refine", "models.plane_sweep", "models.array_pipeline",
    # the cascade slice
    "ops.postfilter", "ops.hatsample", "models.cascade", "models.cascade_sweep",
    # the served capture path
    "roi.mask", "roi.detect", "roi.face", "models.temporal", "parallel.streaming",
    "datasets.native_loader", "datasets.io", "models.serving", "geometry.pointcloud",
    "geometry.cloudops", "models.fusion",
    # SfM and calibration
    "geometry.lie", "geometry.distortion", "geometry.rectify", "evaluation.metrics",
    "sfm.features", "sfm.matching", "sfm.refine", "sfm.segments", "sfm.triangulate", "sfm.ba",
    "sfm.pose_graph", "models.calibration",
)


@pytest.fixture(scope="module")
def jax_after_import():
    """For each camera-array module, imported alone in a fresh interpreter
    (all started together): the jax modules it left in sys.modules."""
    probe = ("import importlib, sys; importlib.import_module(sys.argv[1]); "
             "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib')))")
    procs = {m: subprocess.Popen([sys.executable, "-c", probe, f"stereovisionarray_tpu_torch.{m}"],
                                 cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                 text=True)
             for m in ARRAY_SLICE_MODULES}
    return {m: p.communicate(timeout=300)[0].strip() or "failed to import"
            for m, p in procs.items()}


@pytest.mark.parametrize("module", ARRAY_SLICE_MODULES)
def test_array_slice_module_leaves_jax_out(jax_after_import, module):
    assert jax_after_import[module] == "[]"


def test_no_source_file_imports_jax():
    """Neither the port's modules nor chip_smoke.py import JAX or anything of
    the JAX package (config included: the port keeps its own copy)."""
    offenders = [
        str(path.relative_to(REPO))
        for path in [*PKG.rglob("*.py"), REPO / "chip_smoke.py"]
        for line in path.read_text().splitlines()
        if line.strip().startswith(("import jax", "from jax", "import stereovisionarray_tpu ",
                                    "import stereovisionarray_tpu.", "from stereovisionarray_tpu ",
                                    "from stereovisionarray_tpu."))
    ]
    assert offenders == []


def test_no_not_implemented_error_names_k6_or_k7():
    offenders = [
        str(path.relative_to(REPO))
        for path in PKG.rglob("*.py")
        if "NotImplementedError" in path.read_text() and any(
            k in path.read_text() for k in ("K6", "K7", "item 4a"))
    ]
    assert offenders == []


def _jax_penalties(cost_cfg, sgm_cfg):
    """The reference's derivation, as models/two_view.py:86-112,158 writes it."""
    dtype = jnp.dtype(cost_cfg.dtype)
    if dtype == jnp.int8 and not jax_int8_cost_fits(cost_cfg.census_window,
                                                    cost_cfg.bt_weight, cost_cfg.bt_clip):
        dtype = jnp.dtype(jnp.int16)
    if not jnp.issubdtype(dtype, jnp.integer):
        return str(dtype), 1, sgm_cfg.p1, sgm_cfg.p2, sgm_cfg.p2_min
    scale = jax_cost_scale_for(dtype)
    pen = lambda v: round(v * scale)  # noqa: E731
    return str(dtype), scale, pen(sgm_cfg.p1), pen(sgm_cfg.p2), pen(sgm_cfg.p2_min)


@pytest.mark.parametrize("dtype", ["int8", "int16", "float32"])
@pytest.mark.parametrize("window", [(7, 9), (11, 13), (5, 5)])
@pytest.mark.parametrize("p1,p2,p2_min", [(8.0, 96.0, 24.0), (16.0, 288.0, 72.0),
                                          (2.625, 30.5, 7.5)])
def test_scaled_penalties_match_reference(dtype, window, p1, p2, p2_min):
    cc = CostConfig(census_window=window, dtype=dtype)
    sc = SGMConfig(p1=p1, p2=p2, p2_min=p2_min)
    pen = scaled_penalties(cc, sc, dtype)
    want = _jax_penalties(cc, sc)
    assert (str(pen.dtype).replace("torch.", ""), pen.scale, pen.p1, pen.p2, pen.p2_min) == want


def test_int8_widens_to_int16_for_large_census():
    pen = scaled_penalties(CostConfig(census_window=(11, 13)), SGMConfig(), "int8")
    assert pen.dtype == torch.int16 and pen.scale == 4


def test_backend_follows_device():
    cpu = torch.zeros(2)
    assert resolve_backend(cpu) == "torch"
    assert resolve_backend(cpu, "torch") == "torch"
    with pytest.raises(ValueError):
        resolve_backend(cpu, "cuda")
    with pytest.raises(ValueError):
        resolve_backend(cpu, "pallas")
