"""The rest of the port's public API against the JAX package on the CPU: the
separate census and Birchfield-Tomasi builders (bit-exact in every cost
dtype, with the d_offset hook and out_axes), the numpy SGM oracle, the
epipolar candidates, pair_groups, the masked mean and error image, the
artifact files (.npz, PLY, PFM) written by one package and read by the
other, and the package exports: every name a JAX subpackage's __init__
exports, the port's exports too, but for the named ones that wait for the
port of the sharded paths."""

import importlib
import inspect
import itertools
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereovisionarray_tpu import datasets as jax_datasets
from stereovisionarray_tpu.evaluation import metrics as jax_metrics
from stereovisionarray_tpu.geometry import epipolar as jax_epipolar
from stereovisionarray_tpu.geometry import topology as jax_topology
from stereovisionarray_tpu.ops import cost_volume as jax_cost
from stereovisionarray_tpu.ops.sgm import sgm_aggregate_reference as jax_sgm_reference
from stereovisionarray_tpu_torch import datasets
from stereovisionarray_tpu_torch.evaluation import depth_error_map, masked_mean_error
from stereovisionarray_tpu_torch.geometry import (
    epipolar_candidates,
    pair_groups,
    rectified_shift_candidates,
)
from stereovisionarray_tpu_torch.ops import (
    birchfield_tomasi_volume,
    census_cost_volume,
    sgm_aggregate_reference,
)

# epipolar candidates are float32 backprojections and projections summed in
# another order than XLA's: within this many pixels (~10 float32 ulps of a
# 56-pixel coordinate)
EPIPOLAR_TOL_PX = 5e-5

# exported by the reference, ported with the sharded paths (the next slice)
NEXT_SLICE = {
    "parallel": {"AXIS_DATA", "AXIS_DISP", "AXIS_TILE", "DevicePipeline",
                 "distributed_bundle_adjust", "exchange_halo", "make_mesh",
                 "sharded_cascade_sweep_depth", "sharded_fuse_depth_maps",
                 "sharded_plane_sweep_depth", "sharded_two_view_disparity", "sharded_wta"},
    "utils": {"ElasticRunner", "Heartbeat", "reshard"},
}


def _pair(seed, h=12, w=30):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.0, 255.0, (h, w)).astype(np.float32),
            rng.uniform(0.0, 255.0, (h, w)).astype(np.float32))


@pytest.mark.parametrize("d_offset,out_axes", [(0, -1), (5, 1), (-2, -1)])
@pytest.mark.parametrize("dtype", ["float32", "int8", "int16"])
@pytest.mark.parametrize("builder", ["census_cost_volume", "birchfield_tomasi_volume"])
def test_separate_cost_builders_are_the_references(builder, dtype, d_offset, out_axes):
    left, right = _pair(7)
    extra = {"window": (5, 7)} if builder == "census_cost_volume" else {"clip": 24.0}
    want = getattr(jax_cost, builder)(jnp.asarray(left), jnp.asarray(right), 9,
                                      dtype=jnp.dtype(dtype), d_offset=d_offset,
                                      out_axes=out_axes, **extra)
    port = {"census_cost_volume": census_cost_volume,
            "birchfield_tomasi_volume": birchfield_tomasi_volume}[builder]
    got = port(torch.from_numpy(left), torch.from_numpy(right), 9, dtype=dtype,
               d_offset=d_offset, out_axes=out_axes, **extra).numpy()
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("num_paths", [4, 8])
def test_sgm_aggregate_reference_is_the_references(num_paths):
    vol = np.random.default_rng(num_paths).uniform(0, 40, (8, 10, 6)).astype(np.float32)
    want = jax_sgm_reference(vol, 3.0, 20.0, num_paths)
    got = sgm_aggregate_reference(torch.from_numpy(vol), 3.0, 20.0, num_paths)
    assert got.dtype == np.float64 and np.array_equal(got, want)


def test_epipolar_candidates_match_the_reference():
    from stereovisionarray_tpu.datasets import reference_rig as jax_rig

    res, depths = (12, 16), [0.5, 0.8, 1.3, 4.0]
    want = np.asarray(jax_epipolar.epipolar_candidates(
        jax_rig(rows=3, cols=3, resolution=res), 4, 2, res, jnp.asarray(depths)))
    got = epipolar_candidates(datasets.reference_rig(rows=3, cols=3, resolution=res), 4, 2,
                              res, depths)
    assert tuple(got.shape) == want.shape == (4, 12, 16, 2) and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= EPIPOLAR_TOL_PX


def test_rectified_shift_candidates_and_pair_groups_are_the_references():
    want = np.asarray(jax_epipolar.rectified_shift_candidates(37, 11))
    assert np.array_equal(rectified_shift_candidates(37, 11).numpy(), want)
    for rows, cols in ((5, 5), (3, 4), (1, 6), (2, 2)):
        got, ref = pair_groups("chess", rows, cols), jax_topology.pair_groups("CHESS", rows, cols)
        assert len(got) == len(ref)
        assert all(g.dtype == r.dtype and np.array_equal(g, r) for g, r in zip(got, ref))
    with pytest.raises(ValueError):
        pair_groups("ring")


@pytest.mark.parametrize("mask", ["none", "full", "row"])
def test_masked_mean_error_and_error_map_match_the_reference(mask):
    rng = np.random.default_rng(3)
    depth, gt = (rng.uniform(0.5, 2.0, (20, 24)).astype(np.float32) for _ in range(2))
    m = {"none": None, "full": rng.uniform(size=(20, 24)) > 0.3,
         "row": rng.uniform(size=(1, 24)) > 0.3}[mask]
    want = float(jax_metrics.masked_mean_error(jnp.asarray(depth), jnp.asarray(gt),
                                               None if m is None else jnp.asarray(m)))
    got = float(masked_mean_error(torch.from_numpy(depth), torch.from_numpy(gt),
                                  None if m is None else torch.from_numpy(m)))
    assert abs(got - want) <= 1e-6
    want_map = np.asarray(jax_metrics.depth_error_map(jnp.asarray(depth), jnp.asarray(gt), 20.0))
    got_map = depth_error_map(torch.from_numpy(depth), torch.from_numpy(gt), 20.0).numpy()
    assert np.abs(got_map - want_map).max() <= 1e-6


@pytest.mark.parametrize("colors,valid,normals,quality",
                         list(itertools.product([False, True], repeat=4)))
def test_save_ply_writes_the_references_bytes(tmp_path, colors, valid, normals, quality):
    rng = np.random.default_rng(5)
    kw = {"colors": rng.integers(0, 256, (6, 7, 3)).astype(np.uint8) if colors else None,
          "valid": rng.uniform(size=(6, 7)) > 0.4 if valid else None,
          "normals": rng.normal(size=(6, 7, 3)).astype(np.float32) if normals else None,
          "quality": rng.uniform(size=(6, 7)).astype(np.float32) if quality else None}
    pts = rng.normal(size=(6, 7, 3)).astype(np.float32)
    ref, got = tmp_path / "jax.ply", tmp_path / "port.ply"
    n_ref = jax_datasets.save_ply(str(ref), pts, **kw)
    n_got = datasets.save_ply(str(got), pts, **kw)
    assert n_got == n_ref and got.read_bytes() == ref.read_bytes()
    for read in (datasets.load_ply, jax_datasets.load_ply):  # each package reads the file
        p, c = read(str(got))
        keep = np.ones(42, bool) if kw["valid"] is None else kw["valid"].reshape(-1)
        assert np.array_equal(p, pts.reshape(-1, 3)[keep])
        assert (c is None) == (not colors)
        if colors:
            assert np.array_equal(c, kw["colors"].reshape(-1, 3)[keep])


def test_npz_and_pfm_files_cross_between_the_packages(tmp_path):
    rng = np.random.default_rng(9)
    arrays = {"depth": rng.uniform(size=(5, 6)).astype(np.float32),
              "valid": rng.uniform(size=(5, 6)) > 0.5, "views": np.arange(3)}
    meta = {"config": {"a": 1}, "resolution": [5, 6]}
    for write, read in ((datasets.save_array, jax_datasets.load_array),
                        (jax_datasets.save_array, datasets.load_array)):
        path = str(tmp_path / f"{write.__module__}.npz")
        write(path, arrays, metadata=meta)
        got, got_meta = read(path)
        assert sorted(got) == sorted(arrays) and got_meta == {"version": 1, **meta}
        assert all(got[k].dtype == v.dtype and np.array_equal(got[k], v)
                   for k, v in arrays.items())
    for data in (rng.normal(size=(4, 7)).astype(np.float32),
                 rng.normal(size=(3, 5, 3)).astype(np.float32)):
        port, ref = tmp_path / "port.pfm", tmp_path / "jax.pfm"
        datasets.write_pfm(str(port), data, scale=2.0)
        jax_datasets.write_pfm(str(ref), data, scale=2.0)
        assert port.read_bytes() == ref.read_bytes()
        assert np.array_equal(jax_datasets.read_pfm(str(port)), data)
        assert np.array_equal(datasets.read_pfm(str(ref)), data)


def _exports(module):
    return {n for n, v in vars(module).items() if not n.startswith("_") and not inspect.ismodule(v)}


@pytest.mark.parametrize("sub", ["", "ops", "geometry", "evaluation", "roi", "datasets",
                                 "models", "sfm", "parallel", "utils"])
def test_every_reference_export_is_exported(sub):
    suffix = f".{sub}" if sub else ""
    ref = importlib.import_module("stereovisionarray_tpu" + suffix)
    port = importlib.import_module("stereovisionarray_tpu_torch" + suffix)
    missing = {n for n in _exports(ref) if n not in _exports(port)}
    assert missing == NEXT_SLICE.get(sub, set())


def test_importing_the_exports_builds_nothing():
    """The plain subpackages' re-exports reach no kernel wrapper, and no
    import builds a kernel (models, which launches them, imports the
    wrappers, and roi a helper of ops/sweep_cuda.py)."""
    import subprocess
    import sys

    code = ("import sys\n"
            "import stereovisionarray_tpu_torch.ops, stereovisionarray_tpu_torch.geometry\n"
            "import stereovisionarray_tpu_torch.datasets, stereovisionarray_tpu_torch.utils\n"
            "import stereovisionarray_tpu_torch.evaluation, stereovisionarray_tpu_torch.sfm\n"
            "bad = [m for m in sys.modules if m.startswith('stereovisionarray_tpu_torch') and "
            "m.endswith(('_cuda', '_native', 'hatsample'))]\n"
            "import stereovisionarray_tpu_torch.models, stereovisionarray_tpu_torch.roi\n"
            "import stereovisionarray_tpu_torch.parallel, stereovisionarray_tpu_torch.cli\n"
            "from stereovisionarray_tpu_torch import _native\n"
            "print(bad, _native._lib)\n"
            "sys.exit(1 if bad or _native._lib is not None else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).resolve().parents[1],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
