"""The port's command line (stereovisionarray_tpu_torch/cli.py) on the CPU:
tests/test_cli.py's round trip (render -> depth / reconstruct / two-view /
calibrate / serve / evaluate) and tests/test_debug_utils.py's `inspect`
tests with ``--device cpu``, each artifact (.npz arrays, PLY bytes, PNG
pixels) bit-exact to the port's functions called directly on the images the
CLI decoded; without a card the computing subcommands refuse to run and name
``--device cpu``; config, render and inspect import no kernel wrapper. The
JAX-parity half is tests/test_torch_cli_parity.py."""

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from stereovisionarray_tpu_torch.cli import _rig_from_config, build_parser, load_config, main
from stereovisionarray_tpu_torch.datasets import (
    list_images_sorted,
    load_array,
    load_image_gray,
    load_image_stack,
    read_png,
    save_array,
    save_png,
    save_ply,
)

REPO = Path(__file__).resolve().parents[1]

SMALL = [
    "--set", "camera.rows=3", "--set", "camera.cols=3",
    "--set", "plane_sweep.num_planes=32", "--set", "refine.radius=2",
    "--set", "refine.window=9", "--set", "sgm.num_paths=4",
]
CPU = ["--device", "cpu"]
CENTER = 4  # the 3x3 rig's reference view


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this file runs (six workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(argv):
    """main(argv) in-process: (exit code, its last JSON line)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])


def _cfg(argv):
    return load_config(build_parser().parse_args(argv))


def _same_arrays(path, want: dict):
    got, _ = load_array(path)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        v = v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert np.array_equal(got[k], v), k


def _same_png(tmp_path, path, array, **kw):
    want = str(tmp_path / "want.png")
    save_png(want, np.asarray(array), **kw)
    assert np.array_equal(read_png(path), read_png(want)), path


def _same_ply(tmp_path, path, *args, **kw):
    want = str(tmp_path / "want.ply")
    n = save_ply(want, *args, **kw)
    assert Path(path).read_bytes() == Path(want).read_bytes(), path
    return n


@pytest.fixture(scope="module")
def rendered(tmp_path_factory):
    data = str(tmp_path_factory.mktemp("data"))
    rc = main(["render", "--output", data, "--resolution", "40", "56", *SMALL])
    assert rc == 0
    return data


@pytest.fixture(scope="module")
def stack(rendered):
    """The rendered views as the CLI decodes them, and the config's rig."""
    images = load_image_stack(list_images_sorted(rendered))
    return torch.from_numpy(images), _rig_from_config(_cfg(["depth", "--input", "x", *SMALL]),
                                                      images.shape[1:])


@pytest.fixture(scope="module")
def depth_run(rendered, tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("depth"))
    rc, result = _run(["depth", "--input", rendered, "--output", out_dir, *SMALL, *CPU])
    return rc, result, out_dir


def test_config_subcommand_overrides(capsys):
    rc = main(["config", "--set", "sgm.p1=11", "--set", "plane_sweep.topology=cross"])
    cfg = json.loads(capsys.readouterr().out)
    assert rc == 0
    assert cfg["sgm"]["p1"] == 11
    assert cfg["plane_sweep"]["topology"] == "cross"


def test_load_config_rejects_unknown_key():
    class A:
        config = None
        set = ["nonexistent.key=1"]

    with pytest.raises(KeyError):
        load_config(A())


def test_render_writes_views_and_gt(rendered):
    views = [f for f in os.listdir(rendered) if f.startswith("view_")]
    assert len(views) == 9
    assert os.path.exists(os.path.join(rendered, "ground_truth.npz"))


def test_depth_pipeline_cli(depth_run):
    rc, result, out_dir = depth_run
    assert rc == 0
    assert result["valid_fraction"] > 0.5
    # GT found automatically -> error metrics present and sane
    assert result["median_rel_err"] < 0.05
    for artifact in ("depth.png", "disparity.png", "depth.npz", "cloud.ply",
                     "error.png", "metrics.jsonl"):
        assert os.path.exists(os.path.join(out_dir, artifact)), artifact


def _direct_depth(stack, cfg, images=None):
    from stereovisionarray_tpu_torch.geometry import depth_map_to_points, point_cloud_colors
    from stereovisionarray_tpu_torch.models import array_depth_pipeline

    x, cams = stack
    x = x if images is None else images
    out = array_depth_pipeline(x, cams, cfg)
    pts, pvalid = depth_map_to_points(cams[CENTER], out.refined_depth, mask=out.valid)
    return out, pts, pvalid, point_cloud_colors(x[CENTER], pvalid)


def _check_depth_artifacts(tmp_path, out_dir, direct, result, rendered):
    from stereovisionarray_tpu_torch.evaluation import masked_mean_error

    out, pts, pvalid, col = direct
    _same_arrays(os.path.join(out_dir, "depth.npz"),
                 {"depth": out.refined_depth, "disparity": out.refined_disparity,
                  "valid": out.valid, "confidence": out.sweep.confidence})
    _same_png(tmp_path, os.path.join(out_dir, "depth.png"), out.refined_depth)
    _same_png(tmp_path, os.path.join(out_dir, "disparity.png"), out.refined_disparity)
    n = _same_ply(tmp_path, os.path.join(out_dir, "cloud.ply"), pts.numpy().reshape(-1, 3),
                  colors=col.numpy(), valid=pvalid.numpy().reshape(-1))
    gt = load_array(os.path.join(rendered, "ground_truth.npz"))[0]["depths"][CENTER]
    mask = out.valid.numpy() & (gt > 0)
    err = np.abs(out.refined_depth.numpy() - gt) * mask
    _same_png(tmp_path, os.path.join(out_dir, "error.png"), err)
    assert result["points"] == n
    assert result["valid_fraction"] == float(out.valid.numpy().mean())
    assert result["mean_abs_err"] == float(masked_mean_error(
        out.refined_depth, torch.from_numpy(gt), torch.from_numpy(mask)))


def test_depth_artifacts_equal_direct_calls(depth_run, stack, rendered, tmp_path):
    _, result, out_dir = depth_run
    cfg = _cfg(["depth", "--input", rendered, *SMALL])
    _check_depth_artifacts(tmp_path, out_dir, _direct_depth(stack, cfg), result, rendered)


def test_depth_undistort_equals_direct_calls(rendered, stack, tmp_path):
    """--undistort k1 k2 resamples the whole stack in one call, each view
    through its own camera."""
    from stereovisionarray_tpu_torch.geometry import Distortion, undistort_image

    out_dir = str(tmp_path / "und")
    rc, result = _run(["depth", "--input", rendered, "--output", out_dir, *SMALL, *CPU,
                       "--undistort", "-0.05", "0.01"])
    assert rc == 0
    x, cams = stack
    undist = undistort_image(x, cams, Distortion(-0.05, 0.01))[0]
    cfg = _cfg(["depth", "--input", rendered, *SMALL])
    _check_depth_artifacts(tmp_path, out_dir, _direct_depth(stack, cfg, undist), result,
                           rendered)


def test_depth_probe_reports_the_maps(depth_run, rendered, tmp_path):
    out_dir = str(tmp_path / "probe")
    rc, result = _run(["depth", "--input", rendered, "--output", out_dir, *SMALL, *CPU,
                       "--probe", "3", "4", "--probe", "99", "0"])
    arrays = load_array(os.path.join(out_dir, "depth.npz"))[0]
    assert rc == 0 and [(p["u"], p["v"]) for p in result["probes"]] == [(3, 4), (99, 0)]
    for name in ("depth", "disparity", "valid"):
        assert result["probes"][0][name] == arrays[name][4, 3].item()
        assert result["probes"][1][name] is None


def test_reconstruct_cli(rendered, stack, tmp_path):
    from stereovisionarray_tpu_torch.models.fusion import (
        depth_normals,
        fused_point_cloud,
        reconstruct_array,
    )

    out_dir = str(tmp_path / "recon")
    rc, result = _run([
        "reconstruct", "--input", rendered, "--output", out_dir,
        "--views", "3", "4", "--min-support", "2", "--rel-thresh", "0.02", *SMALL, *CPU,
    ])
    assert rc == 0
    assert result["points"] > 500
    assert result["median_rel_err"] < 0.05
    assert result["mean_support"] >= 2.0
    for artifact in ("fused_cloud.ply", "fused.npz", "metrics.jsonl"):
        assert os.path.exists(os.path.join(out_dir, artifact)), artifact
    # the artifacts, from the port's functions called directly
    x, cams = stack
    res, _ = reconstruct_array(x, cams, _cfg(["reconstruct", "--input", rendered, *SMALL]),
                               view_indices=(3, 4), rel_thresh=0.02, min_support=2)
    pts, conf, col = fused_point_cloud(res, x[[3, 4]])
    sel = cams[[3, 4]]
    nrm = torch.stack([depth_normals(sel[k], res.depth[k], res.valid[k])[0] for k in range(2)])
    c8 = np.clip(col, 0, 255).astype(np.uint8)
    n = _same_ply(tmp_path, os.path.join(out_dir, "fused_cloud.ply"), pts,
                  colors=np.stack([c8] * 3, axis=-1),
                  normals=nrm.numpy().reshape(-1, 3)[res.valid.numpy().reshape(-1)],
                  quality=conf)
    _same_arrays(os.path.join(out_dir, "fused.npz"),
                 {"depths": res.depth, "valid": res.valid, "support": res.support,
                  "confidence": res.confidence, "views": np.asarray((3, 4))})
    assert result["points"] == result["raw_points"] == n


def test_reconstruct_post_processing_cli(rendered, stack, tmp_path):
    """--remove-outliers and --voxel: the cloud is filtered and merged on the
    host, and leaves out the normals."""
    from stereovisionarray_tpu_torch.geometry import remove_outliers, voxel_downsample
    from stereovisionarray_tpu_torch.models.fusion import fused_point_cloud, reconstruct_array

    out_dir = str(tmp_path / "post")
    rc, result = _run([
        "reconstruct", "--input", rendered, "--output", out_dir, "--views", "3", "4",
        "--min-support", "2", "--rel-thresh", "0.02", "--remove-outliers",
        "--outlier-voxel", "0.01", "--voxel", "0.004", *SMALL, *CPU,
    ])
    assert rc == 0
    x, cams = stack
    res, _ = reconstruct_array(x, cams, _cfg(["reconstruct", "--input", rendered, *SMALL]),
                               view_indices=(3, 4), rel_thresh=0.02, min_support=2)
    pts, conf, col = fused_point_cloud(res, x[[3, 4]])
    keep = remove_outliers(pts, voxel=0.01, min_neighbors=3)
    pts, conf, col = voxel_downsample(pts[keep], 0.004, weights=conf[keep], attributes=col[keep])
    c8 = np.clip(col, 0, 255).astype(np.uint8)
    n = _same_ply(tmp_path, os.path.join(out_dir, "fused_cloud.ply"), pts,
                  colors=np.stack([c8] * 3, axis=-1), quality=conf)
    assert result["points"] == n < result["raw_points"]


def test_depth_cascade_cli(rendered, stack, tmp_path):
    out_dir = str(tmp_path / "outc")
    cascade = ["--set", "plane_sweep.cascade_fine_planes=16",
               "--set", "plane_sweep.cascade_band_step=4"]
    rc, result = _run(["depth", "--input", rendered, "--output", out_dir, *SMALL, *CPU,
                       "--cascade", *cascade])
    assert rc == 0
    assert result["valid_fraction"] > 0.5
    assert result["median_rel_err"] < 0.05
    cfg = _cfg(["depth", "--input", rendered, *SMALL, *cascade]).override(
        **{"plane_sweep.cascade": True})
    _check_depth_artifacts(tmp_path, out_dir, _direct_depth(stack, cfg), result, rendered)


def test_depth_rejects_wrong_rig_shape(rendered, tmp_path):
    with pytest.raises(SystemExit):
        main(["depth", "--input", rendered, "--output", str(tmp_path / "x"), *CPU])


def _check_two_view(tmp_path, out_dir, out, result, payload_keys):
    a = {"disparity": out.disparity, "valid": out.valid, "depth": out.depth,
         "confidence": out.confidence}
    _same_arrays(os.path.join(out_dir, "two_view.npz"),
                 {k: a[k] for k in payload_keys})
    _same_png(tmp_path, os.path.join(out_dir, "disparity.png"), out.disparity)
    _same_png(tmp_path, os.path.join(out_dir, "confidence.png"), out.confidence,
              vmin=0.0, vmax=1.0)
    if out.depth is not None:
        _same_png(tmp_path, os.path.join(out_dir, "depth.png"), out.depth)
    v = out.valid.numpy()
    assert result["valid_fraction"] == float(v.mean())
    assert result["mean_confidence"] == float(out.confidence.numpy()[v].mean())


def test_two_view_cli(rendered, tmp_path):
    from stereovisionarray_tpu_torch.models import two_view_disparity

    # neighbouring horizontal views of the rendered rig make a usable pair
    left = os.path.join(rendered, "view_004.png")
    right = os.path.join(rendered, "view_003.png")
    out_dir = str(tmp_path / "tv")
    argv = ["two-view", "--left", left, "--right", right, "--output", out_dir,
            "--set", "cost.num_disparities=32", "--set", "sgm.num_paths=4",
            "--baseline", "0.05", "--focal-px", "416.0"]
    rc, result = _run([*argv, *CPU])
    assert rc == 0
    assert result["valid_fraction"] > 0.3
    assert os.path.exists(os.path.join(out_dir, "depth.png"))
    cfg = _cfg(argv)
    out = two_view_disparity(torch.from_numpy(load_image_gray(left)),
                             torch.from_numpy(load_image_gray(right)), cfg.cost, cfg.sgm,
                             baseline=0.05, focal_px=416.0)
    _check_two_view(tmp_path, out_dir, out, result, ("disparity", "valid", "depth", "confidence"))


def test_two_view_cascade_cli(rendered, tmp_path):
    from stereovisionarray_tpu_torch.models import cascade_two_view_disparity

    left = os.path.join(rendered, "view_004.png")
    right = os.path.join(rendered, "view_003.png")
    out_dir = str(tmp_path / "tvc")
    argv = ["two-view", "--left", left, "--right", right, "--output", out_dir,
            "--set", "cost.num_disparities=64", "--set", "sgm.num_paths=4",
            "--cascade", "--fine-disparities", "16", "--band-step", "4"]
    rc, result = _run([*argv, *CPU])
    assert rc == 0
    assert result["valid_fraction"] > 0.3
    assert os.path.exists(os.path.join(out_dir, "disparity.png"))
    cfg = _cfg(argv)
    out = cascade_two_view_disparity(torch.from_numpy(load_image_gray(left)),
                                     torch.from_numpy(load_image_gray(right)), cfg.cost,
                                     cfg.sgm, coarse_factor=4, fine_disparities=16, band_step=4)
    _check_two_view(tmp_path, out_dir, out, result, ("disparity", "valid", "confidence"))


def test_calibrate_cli(rendered, stack, tmp_path):
    from stereovisionarray_tpu_torch.models import calibrate_array

    out_dir = str(tmp_path / "cal")
    argv = ["calibrate", "--input", rendered, "--output", out_dir, *SMALL,
            "--set", "sfm.max_features=128", "--set", "sfm.ba_iterations=8"]
    rc, result = _run([*argv, *CPU])
    assert rc == 0
    assert result["num_obs"] > 20
    assert result["mean_reproj_px"] < 2.0
    npz = np.load(os.path.join(out_dir, "calibration.npz"))
    assert npz["t"].shape[-1] == 3
    x, cams = stack
    cal = calibrate_array(x, cams, CENTER, _cfg(argv).sfm)
    _same_arrays(os.path.join(out_dir, "calibration.npz"),
                 {"R": cal.cameras.R, "t": cal.cameras.t, "points": cal.points,
                  "point_valid": cal.point_valid})
    assert result["num_obs"] == int(cal.num_obs)
    assert result["mean_reproj_px"] == float(cal.mean_reproj)
    assert "k1" not in result


def test_evaluate_cli(rendered, depth_run, capsys):
    _, _, out_dir = depth_run
    rc, report = _run([
        "evaluate", "--result", os.path.join(out_dir, "depth.npz"),
        "--ground-truth", os.path.join(rendered, "ground_truth.npz"),
        "--key", "depth", "--gt-key", "depths", "--gt-index", "4",
        "--tau", "0.01", "0.02", *CPU,
    ])
    assert rc == 0
    assert report["gt_key"] == "depths"
    assert abs(report["masked_mean_err"]) < 0.01
    assert report["bad_0.02"] < 0.6  # tau in metres here (depth domain)


def _check_served(out_dir, direct, temporal):
    for i, out in enumerate(direct):
        path = os.path.join(out_dir, f"depth_{i:04d}.npz")
        if temporal:
            tout, depth = out
            _same_arrays(path, {"depth": depth, "valid": tout.valid,
                                "stability": tout.stability})
        else:
            _same_arrays(path, {"depth": out.refined_depth, "valid": out.valid})
        assert os.path.exists(os.path.join(out_dir, f"depth_{i:04d}.png"))
    assert os.path.exists(os.path.join(out_dir, "metrics.jsonl"))


def test_serve_cli(rendered, stack, tmp_path):
    """Stream the same rendered frame set twice through `serve`."""
    from stereovisionarray_tpu_torch.models import array_depth_pipeline

    out_dir = str(tmp_path / "srv")
    rc, summary = _run(["serve", rendered, rendered, "--output", out_dir, *SMALL, *CPU])
    assert rc == 0
    assert summary["frames"] == 2
    x, cams = stack
    out = array_depth_pipeline(x, cams, _cfg(["serve", rendered, *SMALL]))
    _check_served(out_dir, [out, out], temporal=False)


def test_serve_temporal_cli(rendered, stack, tmp_path):
    """--temporal --chunk 2 over three sets: the filter's maps, equal to the
    port's temporal_update over direct pipeline outputs in order."""
    from stereovisionarray_tpu_torch.models import (
        array_baselines,
        array_depth_pipeline,
        reference_and_sources,
        temporal_init,
        temporal_update,
    )
    from stereovisionarray_tpu_torch.models.two_view import disparity_to_depth

    out_dir = str(tmp_path / "srvt")
    rc, summary = _run(["serve", rendered, rendered, rendered, "--output", out_dir,
                        "--temporal", "--chunk", "2", *SMALL, *CPU])
    assert rc == 0 and summary["frames"] == 3
    x, cams = stack
    cfg = _cfg(["serve", rendered, *SMALL])
    out = array_depth_pipeline(x, cams, cfg)
    ref, src = reference_and_sources(cfg, 9)
    b0, f_px = array_baselines(cams, ref, src)[1], float(cams.host().fx[ref])
    state, filtered = temporal_init(tuple(out.refined_disparity.shape), "cpu"), []
    for _ in range(3):
        state, tout = temporal_update(state, out.refined_disparity, out.valid,
                                      out.sweep.confidence)
        filtered.append((tout, torch.where(tout.valid, disparity_to_depth(
            tout.disparity, b0, f_px), 0.0)))
    _check_served(out_dir, filtered, temporal=True)


def test_inspect_npz_and_pixel_probe(tmp_path, capsys):
    arr = np.arange(12, dtype=np.float32).reshape(3, 4)
    p = str(tmp_path / "x.npz")
    save_array(p, {"depth": arr}, metadata={"note": "t"})
    rc = main(["inspect", p, "--at", "2", "1"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0
    assert out["depth"]["shape"] == [3, 4]
    assert out["depth"]["at"]["value"] == 6.0
    assert out["depth"]["nonfinite"] == 0


def test_inspect_out_of_bounds(tmp_path, capsys):
    p = str(tmp_path / "x.npz")
    save_array(p, {"d": np.zeros((2, 2), np.float32)})
    main(["inspect", p, "--at", "9", "9"])
    out = json.loads(capsys.readouterr().out)
    assert out["d"]["at"]["value"] is None


COMPUTING = {
    "depth": ["--input", "."], "reconstruct": ["--input", "."],
    "two-view": ["--left", "l.png", "--right", "r.png"], "calibrate": ["--input", "."],
    "serve": ["."], "evaluate": ["--result", "r.npz", "--ground-truth", "g.npz"],
}


@pytest.mark.parametrize("command", sorted(COMPUTING))
def test_no_card_without_device_cpu_refuses(command, monkeypatch):
    """The default device is the card; with none, a computing subcommand
    stops before any work and names --device cpu (no CPU fallback)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        main([command, *COMPUTING[command]])
    assert "--device cpu" in str(exc.value)


def test_module_entry_point_exits_non_zero_without_a_card(rendered, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run(
        [sys.executable, "-m", "stereovisionarray_tpu_torch", "depth", "--input", rendered,
         "--output", str(tmp_path / "o"), *SMALL],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "--device cpu" in proc.stderr
    assert not (tmp_path / "o").exists()


def test_numpy_subcommands_import_no_kernel_wrapper(rendered, depth_run, tmp_path):
    """config, render and inspect compute in numpy: they import neither the
    kernel wrappers nor the kernels' build."""
    out = str(tmp_path / "r")
    code = (
        "import sys\n"
        "from stereovisionarray_tpu_torch.cli import main\n"
        "main(['config'])\n"
        f"main(['render', '--output', {out!r}, '--resolution', '8', '12'])\n"
        f"main(['inspect', {os.path.join(depth_run[2], 'depth.npz')!r}])\n"
        f"main(['inspect', {os.path.join(rendered, 'view_000.png')!r}])\n"
        "bad = [m for m in sys.modules if m.startswith('stereovisionarray_tpu_torch') and "
        "(m.endswith(('_cuda', '_native', 'hatsample')) or '.models' in m)]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_help_lists_the_nine_subcommands():
    sub = next(a for a in build_parser()._actions if a.dest == "command")
    assert sorted(sub.choices) == sorted(["config", "render", "depth", "reconstruct", "two-view",
                                          "calibrate", "serve", "evaluate", "inspect"])
    for name, parser in sub.choices.items():
        device = next((a for a in parser._actions if a.dest == "device"), None)
        if name in COMPUTING:
            assert device.default == "cuda" and tuple(device.choices) == ("cuda", "cpu")
        else:
            assert device is None, name
