"""The port's command line against the JAX package's (stereovisionarray_tpu/cli.py)
on the CPU, both run in-process on the same folder: the same flags and
defaults (``--platform`` replaced by ``--device``), the same config JSON,
the same rendered pixels and ground truth, and the same keys in every
printed JSON line (those of torch_records.CLI_KEYS among them). The reference's
CPU run takes its XLA route and the port its plain twin of the kernel route,
so their depth maps agree by scripts/check_tpu_parity.py:34-57's rule: at
least 99% of the pixels valid in both within 0.5 px and at least 97% of the
pixels agreeing on validity. `two-view` is bit-exact to the reference's
kernels in interpret mode; `evaluate` and `inspect` agree on the same file."""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

import torch_records
from stereovisionarray_tpu import cli as jax_cli
from stereovisionarray_tpu_torch import cli
from stereovisionarray_tpu_torch.datasets import load_array, load_image_gray, read_png

SMALL = [
    "--set", "camera.rows=3", "--set", "camera.cols=3",
    "--set", "plane_sweep.num_planes=32", "--set", "refine.radius=2",
    "--set", "refine.window=9", "--set", "sgm.num_paths=4",
]
CPU = ["--device", "cpu"]
TWO_VIEW = ["--set", "cost.num_disparities=32", "--set", "sgm.num_paths=4",
            "--baseline", "0.05", "--focal-px", "416.0"]
CALIBRATE = ["--set", "sfm.max_features=128", "--set", "sfm.ba_iterations=8",
             "--estimate-distortion"]
# the calibration sits in a flat valley, so float order alone moves its
# reprojection numbers: held to torch_records' bound on the reference
# scale's inlier reprojection, and its distortion to the bound on k1
REPROJ_TOL = torch_records.SFM_RECORD_TOL["inlier_reproj_px"]
K_TOL = torch_records.SFM_RECORD_TOL["k1"]
# fused depths agree within the fusion's own default agreement tolerance
# (reconstruct --rel-thresh 0.01)
FUSED_REL_TOL = 0.01


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this file runs (six workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(main, argv):
    """main(argv) in-process: its last printed JSON line (config prints one
    JSON document over many lines)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    text = buf.getvalue().strip()
    return json.loads(text if argv[0] == "config" else text.splitlines()[-1])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every subcommand through both CLIs, once: name -> (reference's JSON,
    port's JSON, reference's output dir, port's output dir)."""
    root = tmp_path_factory.mktemp("cli")
    data = str(root / "data")
    out = {"render": (_run(jax_cli.main, ["render", "--output", str(root / "jax_data"),
                                          "--resolution", "40", "56", *SMALL]),
                      _run(cli.main, ["render", "--output", data, "--resolution", "40", "56",
                                      *SMALL]),
                      str(root / "jax_data"), data)}
    left, right = os.path.join(data, "view_004.png"), os.path.join(data, "view_003.png")
    argv = {
        "depth": ["--input", data, *SMALL],
        "reconstruct": ["--input", data, "--views", "3", "4", "--min-support", "2",
                        "--rel-thresh", "0.02", *SMALL],
        "two-view": ["--left", left, "--right", right, *TWO_VIEW],
        "calibrate": ["--input", data, *SMALL, *CALIBRATE],
        "serve": [data, data, *SMALL],
    }
    for name, args in argv.items():
        jdir, pdir = str(root / f"jax_{name}"), str(root / f"port_{name}")
        out[name] = (_run(jax_cli.main, [name, *args, "--output", jdir]),
                     _run(cli.main, [name, *args, "--output", pdir, *CPU]), jdir, pdir)
    result = os.path.join(out["depth"][3], "depth.npz")
    ev = ["--result", result, "--ground-truth", os.path.join(data, "ground_truth.npz"),
          "--gt-key", "depths", "--gt-index", "4"]
    out["evaluate"] = (_run(jax_cli.main, ["evaluate", *ev]),
                       _run(cli.main, ["evaluate", *ev, *CPU]), None, None)
    out["inspect"] = (_run(jax_cli.main, ["inspect", result, "--at", "3", "4"]),
                      _run(cli.main, ["inspect", result, "--at", "3", "4"]), None, None)
    out["config"] = (_run(jax_cli.main, ["config", *SMALL]), _run(cli.main, ["config", *SMALL]),
                     None, None)
    return out


def _options(parser):
    return {a.option_strings[0] if a.option_strings else a.dest: (a.default, a.nargs, a.choices)
            for a in parser._actions if a.dest != "help"}


def _subparsers(parser):
    return next(a for a in parser._actions if a.dest == "command").choices


@pytest.mark.parametrize("command", ["config", "render", "depth", "reconstruct", "two-view",
                                     "calibrate", "serve", "evaluate", "inspect"])
def test_flags_and_defaults_are_the_references(command):
    ref = _options(_subparsers(jax_cli.build_parser())[command])
    got = _options(_subparsers(cli.build_parser())[command])
    ref.pop("--platform", None)
    if command in ("depth", "reconstruct", "two-view", "calibrate", "serve", "evaluate"):
        assert got.pop("--device") == ("cuda", None, ("cuda", "cpu"))
    assert got == ref


@pytest.mark.parametrize("argv", [[], ["--set", "sgm.p1=11", "--set", "plane_sweep.topology=cross"],
                                  "file"])
def test_config_prints_the_references_json(argv, tmp_path, capsys):
    if argv == "file":  # a config file written by the reference, read by both
        from stereovisionarray_tpu.config import EngineConfig as JaxConfig

        path = tmp_path / "cfg.json"
        path.write_text(JaxConfig().override(**{"cost.num_disparities": 96,
                                                "camera.rows": 3}).to_json())
        argv = ["--config", str(path)]
    jax_cli.main(["config", *argv])
    ref = capsys.readouterr().out
    cli.main(["config", *argv])
    assert capsys.readouterr().out == ref


def test_render_writes_the_references_pixels_and_ground_truth(runs):
    jdir, pdir = runs["render"][2:]
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(pdir))
    for name in names:
        if name.endswith(".png"):
            assert np.array_equal(read_png(os.path.join(jdir, name)),
                                  read_png(os.path.join(pdir, name))), name
    (ref, ref_meta), (got, got_meta) = (load_array(os.path.join(d, "ground_truth.npz"))
                                        for d in (jdir, pdir))
    assert np.array_equal(ref["depths"], got["depths"]) and ref_meta == got_meta


@pytest.mark.parametrize("command", ["config", "render", "depth", "reconstruct", "two-view",
                                     "calibrate", "serve", "evaluate", "inspect"])
def test_printed_keys_are_the_references(runs, command):
    ref, got = runs[command][:2]
    assert sorted(got) == sorted(ref)
    if command == "inspect":
        for name in ref:
            assert sorted(got[name]) == sorted(ref[name]), name
    if command in torch_records.CLI_KEYS:  # the key sets the card suite holds its runs to
        assert sorted(torch_records.CLI_KEYS[command]) == sorted(ref)


def _agree(ref_d, ref_v, got_d, got_v, within):
    """Shares of (pixels valid in both within `within`, validity agreement)."""
    both = ref_v & got_v
    close = within(np.abs(got_d - ref_d)[both], ref_d[both])
    return close.mean(), (ref_v == got_v).mean()


def test_depth_agrees_with_the_reference(runs):
    ref_out, got_out, jdir, pdir = runs["depth"]
    ref, got = (load_array(os.path.join(d, "depth.npz"))[0] for d in (jdir, pdir))
    assert sorted(got) == sorted(ref)
    close, valid = _agree(ref["disparity"], ref["valid"], got["disparity"], got["valid"],
                          lambda e, _: e <= 0.5)
    assert close >= 0.99 and valid >= 0.97, (close, valid)
    assert got_out["points"] == int(got["valid"].sum())
    assert abs(got_out["median_rel_err"] - ref_out["median_rel_err"]) < 0.005


def test_reconstruct_agrees_with_the_reference(runs):
    ref_out, got_out, jdir, pdir = runs["reconstruct"]
    ref, got = (load_array(os.path.join(d, "fused.npz"))[0] for d in (jdir, pdir))
    assert sorted(got) == sorted(ref) and np.array_equal(got["views"], ref["views"])
    close, valid = _agree(ref["depths"], ref["valid"], got["depths"], got["valid"],
                          lambda e, d: e <= FUSED_REL_TOL * d)
    assert close >= 0.99 and valid >= 0.97, (close, valid)
    assert got_out["views"] == ref_out["views"] == [3, 4]


def test_serve_agrees_with_the_reference(runs):
    """The served depths as disparities (f * B0 / depth), by the same rule."""
    from stereovisionarray_tpu_torch.models import array_baselines, reference_and_sources

    _, got_out, jdir, pdir = runs["serve"]
    assert got_out["frames"] == 2
    cfg = cli.load_config(cli.build_parser().parse_args(["serve", ".", *SMALL]))
    cams = cli._rig_from_config(cfg, (40, 56))
    ref_index, src = reference_and_sources(cfg, 9)
    fb = float(cams.host().fx[ref_index]) * array_baselines(cams, ref_index, src)[1]
    for i in range(2):
        ref, got = (load_array(os.path.join(d, f"depth_{i:04d}.npz"))[0] for d in (jdir, pdir))
        disp = [np.where(a["valid"], fb / np.where(a["valid"], a["depth"], 1.0), 0.0)
                for a in (ref, got)]
        close, valid = _agree(disp[0], ref["valid"], disp[1], got["valid"],
                              lambda e, _: e <= 0.5)
        assert close >= 0.99 and valid >= 0.97, (i, close, valid)


def test_two_view_is_bit_exact_to_the_reference_kernels(runs):
    """The CLI's int16 run on its decoded pair equals the reference's
    two_view_disparity through its kernels in interpret mode."""
    import jax.numpy as jnp

    from stereovisionarray_tpu.config import EngineConfig as JaxConfig
    from stereovisionarray_tpu.models import two_view_disparity

    got = load_array(os.path.join(runs["two-view"][3], "two_view.npz"))[0]
    cfg = JaxConfig().override(**{"cost.num_disparities": 32, "sgm.num_paths": 4})
    assert cfg.cost.dtype == "int16"
    data = runs["render"][3]
    left, right = (jnp.asarray(load_image_gray(os.path.join(data, f"view_00{i}.png")))
                   for i in (4, 3))
    ref = two_view_disparity(left, right, cfg.cost, cfg.sgm, baseline=0.05, focal_px=416.0,
                             backend="pallas_interpret")
    for key in ("disparity", "valid", "confidence", "depth"):
        assert np.array_equal(got[key], np.asarray(getattr(ref, key))), key


def test_calibrate_agrees_with_the_reference(runs):
    ref, got = runs["calibrate"][:2]
    assert got["num_obs"] == ref["num_obs"]
    assert got["inlier_threshold_px"] == ref["inlier_threshold_px"]
    for key in ("mean_reproj_px", "inlier_reproj_px"):
        assert abs(got[key] - ref[key]) <= REPROJ_TOL, key
    for key in ("k1", "k2"):
        assert abs(got[key] - ref[key]) <= K_TOL, key


def test_evaluate_agrees_with_the_reference(runs):
    ref, got = runs["evaluate"][:2]
    assert got["key"] == ref["key"] and got["gt_key"] == ref["gt_key"]
    for key, value in ref.items():
        if key not in ("key", "gt_key"):
            assert abs(got[key] - value) <= 1e-6, key


def test_inspect_prints_the_references_json(runs, capsys):
    assert runs["inspect"][0] == runs["inspect"][1]
    png = os.path.join(runs["render"][3], "view_000.png")
    jax_cli.main(["inspect", png, "--at", "5", "7"])
    ref = capsys.readouterr().out
    cli.main(["inspect", png, "--at", "5", "7"])
    assert capsys.readouterr().out == ref
