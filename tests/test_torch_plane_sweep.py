"""The port's plane sweep against the JAX reference on small rigs.

K8's plain twin vs ``plane_sweep_census_pallas(interpret=True)`` on
integer-valued images (where the reference's bf16 hi/lo warp is exact): the
view counts exact; fused costs equal except where the reference's
interpret-mode lerp is contracted into a fused multiply-add and a census bit
flips at an exact tie, bounded as ``tests/test_sweep_pallas.py:82-84`` bounds
the kernel against XLA (<= 2/S, on < 1% of the values). The per-plane chain vs
``plane_sweep_volume(backend="xla")``; ``_volume_to_maps`` fed the reference's
own fused volume bit-exact to its ``pallas_interpret`` route.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereovisionarray_tpu.config import EngineConfig
from stereovisionarray_tpu.datasets import reference_rig as jax_rig
from stereovisionarray_tpu.models import plane_sweep as jps
from stereovisionarray_tpu.ops.sweep_pallas import plane_sweep_census_pallas
from stereovisionarray_tpu_torch.datasets.synthetic import reference_rig, render_camera_array
from stereovisionarray_tpu_torch.geometry import inverse_depth_samples
from stereovisionarray_tpu_torch.models import plane_sweep as ps
from stereovisionarray_tpu_torch.models.array_pipeline import _shift_warp_pad, reference_and_sources
from stereovisionarray_tpu_torch.ops.sweep_cuda import plane_sweep_census, plane_sweep_census_plain


def _rig(rows, cols, h, w, planes, **overrides):
    """Integer-valued rendered images of a rows x cols rig, both packages'
    rigs, the config, the reference and source views and the shift bound."""
    cfg = EngineConfig().override(**{"camera.rows": rows, "camera.cols": cols,
                                     "plane_sweep.num_planes": planes, **overrides})
    cams = reference_rig(rows=rows, cols=cols, resolution=(h, w))
    images = np.round(render_camera_array(cams, (h, w))[0])
    ref, src = reference_and_sources(cfg, rows * cols)
    pad = _shift_warp_pad(cams, ref, src, cfg)
    assert pad > 0
    return images, cams, jax_rig(rows=rows, cols=cols, resolution=(h, w)), cfg, ref, src, pad


def _shifts(cams, ref, src, cfg):
    p = cfg.plane_sweep
    depths = inverse_depth_samples(p.z_near, p.z_far, p.num_planes)
    return np.ascontiguousarray(ps.translation_shifts(cams, ref, src, depths).swapaxes(0, 1))


def _assert_within_tie_bound(got, want, n_views):
    d = np.abs(got - want)
    assert d.max() <= 2.0 / n_views + 1e-6, d.max()
    assert (d > 0).mean() < 0.01, (d > 0).mean()


@pytest.mark.parametrize("rows,cols,h,w,planes,topology,patch,fusion", [
    (3, 3, 48, 64, 16, "CROSS", 3, dict()),  # S=4, k >= S: ceiling-padded mean
    (3, 3, 48, 64, 16, "CROSS", 5, dict()),
    (3, 3, 48, 64, 16, "CROSS", 7, dict()),
    (3, 3, 48, 64, 16, "CROSS", 5, dict(valid_mean=True)),
    (5, 5, 24, 32, 8, "to_center", 5, dict(topk=1)),  # S=24: the many-view kernel
    (5, 5, 24, 32, 8, "to_center", 5, dict(topk=3)),
    (5, 5, 24, 32, 8, "to_center", 5, dict(topk=6)),
    (5, 5, 24, 32, 8, "to_center", 5, dict(topk=23)),
])
def test_census_sweep_plain_matches_pallas(rows, cols, h, w, planes, topology, patch, fusion):
    images, cams, _, cfg, ref, src, pad = _rig(rows, cols, h, w, planes,
                                               **{"plane_sweep.topology": topology})
    shifts = _shifts(cams, ref, src, cfg)
    fused, nv = plane_sweep_census_plain(torch.from_numpy(images[ref]),
                                         torch.from_numpy(images[list(src)]),
                                         torch.from_numpy(shifts), patch=patch, **fusion)
    want_f, want_n = plane_sweep_census_pallas(jnp.asarray(images[ref]),
                                               jnp.asarray(images[list(src)]),
                                               jnp.asarray(shifts), patch=patch, shift_pad=pad,
                                               interpret=True, **fusion)
    assert fused.shape == (h, w, planes) and nv.dtype == torch.int32
    np.testing.assert_array_equal(nv.numpy(), np.moveaxis(np.asarray(want_n), 0, -1))
    _assert_within_tie_bound(fused.numpy(), np.moveaxis(np.asarray(want_f), 0, -1), len(src))
    # the wrapper takes the plain twin for a CPU tensor
    again = plane_sweep_census(torch.from_numpy(images[ref]), torch.from_numpy(images[list(src)]),
                               torch.from_numpy(shifts), patch=patch, **fusion)
    assert torch.equal(again[0], fused) and torch.equal(again[1], nv)


def test_sentinel_pad_divergence_of_sweep_pallas_356():
    """With 9 sources (> 8, not a multiple of the 6-view chunk) and a plain
    mean, the reference's many-view kernel adds the ceiling for its 3 sentinel
    pad views but divides by 9 (sweep_pallas.py:356). The port holds to
    _fuse_views instead: its costs are the reference kernel's less
    3 * ceiling / 9, and agree with the XLA chain's mean."""
    images, cams, jcams, cfg, ref, src, pad = _rig(2, 5, 24, 32, 6,
                                                   **{"plane_sweep.topk": 9})
    assert len(src) == 9
    shifts = _shifts(cams, ref, src, cfg)
    fused, nv = plane_sweep_census_plain(torch.from_numpy(images[ref]),
                                         torch.from_numpy(images[list(src)]),
                                         torch.from_numpy(shifts))
    kern, _ = plane_sweep_census_pallas(jnp.asarray(images[ref]), jnp.asarray(images[list(src)]),
                                        jnp.asarray(shifts), patch=5, shift_pad=pad,
                                        interpret=True)
    excess = np.moveaxis(np.asarray(kern), 0, -1) - fused.numpy()
    assert (np.abs(excess - 3 * 24 / 9) < 1e-4).mean() > 0.99
    xla, nv_x, _ = jps.plane_sweep_volume(jnp.asarray(images), jcams, ref, src, cfg.plane_sweep,
                                          shift_pad=pad, backend="xla")
    np.testing.assert_array_equal(nv.numpy(), np.asarray(nv_x))
    inner = np.s_[2:-2, 2:-2]  # the XLA chain edge-clamps the warped image's census ring
    _assert_within_tie_bound(fused.numpy()[inner], np.asarray(xla)[inner], 9)


@pytest.mark.parametrize("cost", ["census", "sad", "zncc"])
@pytest.mark.parametrize("fusion", ["mean", "topk_mean", "min"])
def test_shift_chain_matches_xla(cost, fusion):
    images, cams, jcams, cfg, ref, src, pad = _rig(
        3, 3, 48, 64, 16, **{"plane_sweep.topology": "CROSS", "plane_sweep.cost": cost,
                             "plane_sweep.fusion": fusion, "plane_sweep.topk": 2})
    got, nv = ps._shift_chain_volume(torch.from_numpy(images[ref]),
                                     torch.from_numpy(images[list(src)]),
                                     torch.from_numpy(_shifts(cams, ref, src, cfg)),
                                     cfg.plane_sweep, pad)
    want, nv_w, _ = jps.plane_sweep_volume(jnp.asarray(images), jcams, ref, src, cfg.plane_sweep,
                                           shift_pad=pad, backend="xla")
    np.testing.assert_array_equal(nv.numpy(), np.asarray(nv_w))
    d = np.abs(got.numpy() - np.asarray(want))
    if cost == "census":
        # the reference's compiled chain contracts its lerp into fused
        # multiply-adds, which flips census bits at near-ties: on ~1% of the
        # fused values here (0.3% for min, 1.3% for the valid mean), each
        # bounded by the ceiling
        assert (d > 0).mean() < 0.02 and d.max() <= 24
    elif cost == "sad":
        assert d.max() < 2e-3
    else:  # zncc: 1 - ncc amplifies float-order noise where the variance is small
        assert (d < 1e-3).mean() > 0.99 and d.max() <= 2.0
    if fusion != "min" and cost == "census":  # the port's own routing sends this to K8
        vol, _, _ = ps.plane_sweep_volume(torch.from_numpy(images), cams, ref, src,
                                          cfg.plane_sweep, shift_pad=pad)
        assert vol.shape == got.shape


def test_homography_path_matches_xla():
    images, cams, jcams, cfg, ref, src, _ = _rig(3, 3, 32, 40, 8,
                                                 **{"plane_sweep.topology": "CROSS"})
    got, nv, depths = ps.plane_sweep_volume(torch.from_numpy(images), cams, ref, src,
                                            cfg.plane_sweep, shift_pad=0)
    want, nv_w, depths_w = jps.plane_sweep_volume(jnp.asarray(images), jcams, ref, src,
                                                  cfg.plane_sweep, shift_pad=0, backend="xla")
    # inside a jit the reference constant-folds its plane depths, which can
    # differ in the last bit from the eager values the port holds to
    np.testing.assert_allclose(depths.numpy(), np.asarray(depths_w), rtol=1e-6)
    assert (nv.numpy() == np.asarray(nv_w)).mean() > 0.99
    assert (np.abs(got.numpy() - np.asarray(want)) <= 1.0).mean() > 0.98


@pytest.mark.parametrize("cost,patch,dtype", [("census", 5, torch.int8), ("census", 7, torch.int16),
                                              ("sad", 5, torch.int16), ("zncc", 5, torch.float32)])
def test_volume_to_maps_bit_exact_to_pallas(monkeypatch, cost, patch, dtype):
    """Fed the reference's own fused volume, the quantized SGM route (K2/K3 +
    K4 twins) equals the reference's pallas_interpret route bit for bit; so
    does ZNCC under the default SGM, whose penalties do not quantize (float
    K7 in the wdh order + K6 twins)."""
    images, cams, jcams, cfg, ref, src, pad = _rig(
        3, 3, 48, 64, 16, **{"plane_sweep.topology": "CROSS", "plane_sweep.cost": cost,
                             "plane_sweep.patch": patch})
    vol, _, _ = jps.plane_sweep_volume(jnp.asarray(images), jcams, ref, src, cfg.plane_sweep,
                                       shift_pad=pad, backend="xla")
    want = jps._volume_to_maps(vol, jnp.asarray(images[ref]), cfg.plane_sweep, cfg.sgm,
                               "pallas_interpret")
    seen = []
    for name in ("sgm_aggregate_paths", "sgm_aggregate_float"):
        real = getattr(ps, name)
        monkeypatch.setattr(ps, name, lambda v, *a, _real=real, **k: seen.append(v.dtype)
                            or _real(v, *a, **k))
    got = ps._volume_to_maps(torch.from_numpy(np.array(vol)), torch.from_numpy(images[ref]),
                             cfg.plane_sweep, cfg.sgm, "auto")
    assert seen == [dtype]
    for name, a, b in zip(("k", "cost", "conf", "k_int"), got, want):
        assert a.numpy().dtype == np.asarray(b).dtype, name
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


@pytest.mark.parametrize("cost,dtype", [("census", torch.int8), ("zncc", torch.int16)])
def test_volume_to_maps_without_sgm_bit_exact_to_pallas(monkeypatch, cost, dtype):
    """sgm_cfg=None: raw WTA of the quantized volume through the K6 twin,
    bit-exact to the reference's pallas_interpret route."""
    images, cams, jcams, cfg, ref, src, pad = _rig(
        3, 3, 48, 64, 16, **{"plane_sweep.topology": "CROSS", "plane_sweep.cost": cost})
    vol, _, _ = jps.plane_sweep_volume(jnp.asarray(images), jcams, ref, src, cfg.plane_sweep,
                                       shift_pad=pad, backend="xla")
    want = jps._volume_to_maps(vol, jnp.asarray(images[ref]), cfg.plane_sweep, None,
                               "pallas_interpret")
    seen = []
    real = ps.extract_disparity_maps
    monkeypatch.setattr(ps, "extract_disparity_maps",
                        lambda v, *a, **k: seen.append(v.dtype) or real(v, *a, **k))
    got = ps._volume_to_maps(torch.from_numpy(np.array(vol)), torch.from_numpy(images[ref]),
                             cfg.plane_sweep, None, "auto")
    assert seen == [dtype]
    for name, a, b in zip(("k", "cost", "conf", "k_int"), got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


@pytest.mark.parametrize("case", ["no_sgm", "zncc_float"])
def test_float_routes_match_xla_on_cpu(case):
    overrides = {"plane_sweep.topology": "CROSS"}
    if case == "zncc_float":
        overrides["plane_sweep.cost"] = "zncc"  # penalties overflow the int16 scale: float
    images, cams, jcams, cfg, ref, src, pad = _rig(3, 3, 48, 64, 16, **overrides)
    sgm = None if case == "no_sgm" else cfg.sgm
    vol, _, _ = jps.plane_sweep_volume(jnp.asarray(images), jcams, ref, src, cfg.plane_sweep,
                                       shift_pad=pad, backend="xla")
    k_w, c_w, conf_w, ki_w = jps._volume_to_maps(vol, jnp.asarray(images[ref]), cfg.plane_sweep,
                                                  sgm, "xla")
    k, c, conf, ki = ps._volume_to_maps(torch.from_numpy(np.array(vol)),
                                        torch.from_numpy(images[ref]), cfg.plane_sweep, sgm,
                                        "xla")
    assert (ki.numpy() == np.asarray(ki_w)).mean() > 0.99
    assert (np.abs(k.numpy() - np.asarray(k_w)) < 1e-3).mean() > 0.99
    np.testing.assert_allclose(conf.numpy(), np.asarray(conf_w), atol=1e-3)


def test_plane_sweep_depth_matches_pallas_route():
    images, cams, jcams, cfg, ref, src, pad = _rig(3, 3, 48, 64, 16,
                                                   **{"plane_sweep.topology": "CROSS"})
    mask = np.ones((48, 64), bool)
    mask[:4] = False
    got = ps.plane_sweep_depth(torch.from_numpy(images), cams, ref, src, cfg.plane_sweep, cfg.sgm,
                               mask=torch.from_numpy(mask), shift_pad=pad)
    want = jps.plane_sweep_depth(jnp.asarray(images), jcams, ref, src, cfg.plane_sweep, cfg.sgm,
                                 mask=jnp.asarray(mask), shift_pad=pad, backend="pallas_interpret")
    assert (got.valid.numpy() == np.asarray(want.valid)).mean() > 0.99
    assert not got.valid.numpy()[:4].any()
    assert (got.plane.numpy() == np.asarray(want.plane)).mean() > 0.99
    assert (got.num_views.numpy() == np.asarray(want.num_views)).mean() > 0.99
    both = got.valid.numpy() & np.asarray(want.valid)
    assert (np.abs(got.depth.numpy() - np.asarray(want.depth))[both] < 1e-5).mean() > 0.99
