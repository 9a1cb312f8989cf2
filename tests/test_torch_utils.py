"""The port's utils/ (checkpoint, profiling, metrics log, debug harness) on
the CPU: tests/test_utils.py and the checked / assert_deterministic /
find_nonfinite tests of tests/test_debug_utils.py on the port, and what
crosses between the packages: the JSONL lines (either package's
read_metrics reads the other's), engine_config.json (the same text), and
find_nonfinite's key strings (those jax.tree_util.keystr gives)."""

import json
import os
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereovisionarray_tpu.config import EngineConfig as JaxConfig
from stereovisionarray_tpu.utils import find_nonfinite as jax_find_nonfinite
from stereovisionarray_tpu.utils import save_checkpoint as jax_save_checkpoint
from stereovisionarray_tpu.utils.obslog import MetricsLogger as JaxMetricsLogger
from stereovisionarray_tpu.utils.obslog import read_metrics as jax_read_metrics
from stereovisionarray_tpu_torch.config import EngineConfig
from stereovisionarray_tpu_torch.utils import (
    MetricsLogger,
    StageTimer,
    assert_deterministic,
    checked,
    find_nonfinite,
    load_checkpoint,
    save_checkpoint,
    time_fn,
    trace,
)
from stereovisionarray_tpu_torch.utils.debug import FloatCheckError
from stereovisionarray_tpu_torch.utils.obslog import read_metrics


class TestCheckpoint:
    def test_roundtrip_state_and_config(self, tmp_path):
        state = {
            "depth": torch.arange(12.0).reshape(3, 4),
            "poses": {"R": torch.eye(3), "t": torch.zeros(3)},
            "step": torch.tensor(7),
        }
        cfg = EngineConfig().override(**{"sgm.p1": 11.0})
        path = str(tmp_path / "ckpt")
        save_checkpoint(path, state, cfg)
        restored, cfg2 = load_checkpoint(path)
        np.testing.assert_allclose(np.asarray(restored["depth"]), state["depth"].numpy())
        np.testing.assert_allclose(np.asarray(restored["poses"]["R"]), np.eye(3))
        assert int(restored["step"]) == 7
        assert cfg2.sgm.p1 == 11.0

    def test_resume_after_partial_work(self, tmp_path):
        """The resume pattern: save at step k, restore, continue."""
        path = str(tmp_path / "ckpt2")
        save_checkpoint(path, {"acc": torch.tensor(3.0), "it": torch.tensor(5)})
        state, _ = load_checkpoint(path)
        acc = state["acc"] + 1.0
        assert float(acc) == 4.0 and int(state["it"]) == 5

    def test_force_false_refuses_to_overwrite(self, tmp_path):
        path = str(tmp_path / "ckpt3")
        save_checkpoint(path, {"a": torch.ones(2)}, force=False)
        with pytest.raises(FileExistsError):
            save_checkpoint(path, {"a": torch.zeros(2)}, force=False)
        save_checkpoint(path, {"a": torch.zeros(2)})  # force=True, the default
        assert float(load_checkpoint(path)[0]["a"].sum()) == 0.0

    def test_target_gives_structure_dtype_and_arrays(self, tmp_path):
        """NamedTuples and numpy arrays save as dicts of tensors; a target
        tree restores the structure, each leaf in its target's dtype."""

        class Pose(NamedTuple):
            R: torch.Tensor
            t: np.ndarray

        path = str(tmp_path / "ckpt4")
        save_checkpoint(path, {"pose": Pose(torch.eye(3), np.arange(3.0)), "n": 4})
        raw, cfg = load_checkpoint(path)
        assert cfg is None and set(raw["pose"]) == {"R", "t"} and raw["n"] == 4
        target = {"pose": Pose(torch.zeros(3, 3, dtype=torch.float64),
                               np.zeros(3, np.float32)), "n": 0}
        got, _ = load_checkpoint(path, target=target)
        assert isinstance(got["pose"], Pose) and got["pose"].R.dtype == torch.float64
        assert got["pose"].t.dtype == np.float32 and np.array_equal(got["pose"].t, [0, 1, 2])

    def test_engine_config_json_is_the_references(self, tmp_path):
        """The same file name and text in both packages, and each package
        loads the other's."""
        overrides = {"sgm.p1": 11.0, "camera.rows": 3, "plane_sweep.topology": "CROSS"}
        jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
        jax_save_checkpoint(jax_dir, {"x": jnp.ones(2)}, JaxConfig().override(**overrides))
        save_checkpoint(port_dir, {"x": torch.ones(2)}, EngineConfig().override(**overrides))
        ref = open(os.path.join(jax_dir, "engine_config.json")).read()
        assert open(os.path.join(port_dir, "engine_config.json")).read() == ref
        assert EngineConfig.from_json(ref) == EngineConfig().override(**overrides)


class TestProfiling:
    def test_time_fn_positive(self):
        x = torch.ones((64, 64))
        dt = time_fn(lambda a: a * 2 + 1, x, iters=3, warmup=1)
        assert dt > 0

    def test_stage_timer(self):
        t = StageTimer()
        with t.stage("a"):
            _ = torch.ones((32, 32)).sum()
        with t.stage("a"):
            pass
        with t.stage("b"):
            pass
        rep = t.report()
        assert set(rep) == {"a", "b"}
        assert t.counts["a"] == 2
        assert "a:" in str(t)

    def test_trace_writes_a_chrome_trace(self, tmp_path):
        with trace(str(tmp_path / "tr")):
            torch.ones((16, 16)).matmul(torch.ones((16, 16)))
        events = json.load(open(tmp_path / "tr" / "trace.json"))["traceEvents"]
        assert any("mm" in e.get("name", "") for e in events)


class TestMetricsLogger:
    def test_jsonl_roundtrip(self, tmp_path):
        p = str(tmp_path / "m.jsonl")
        log = MetricsLogger(p)
        log.log("two_view", bad2=torch.tensor(0.02), mps=3.5, note="x")
        log.log("calib", ate=0.001)
        rows = read_metrics(p)
        assert len(rows) == 2
        assert rows[0]["event"] == "two_view"
        assert abs(rows[0]["bad2"] - 0.02) < 1e-6
        assert rows[1]["ate"] == 0.001
        assert "ts" in rows[0]

    def test_each_package_reads_the_others_lines(self, tmp_path):
        port, ref = str(tmp_path / "port.jsonl"), str(tmp_path / "jax.jsonl")
        MetricsLogger(port).log("frame", index=3, valid_fraction=np.float32(0.5), note="x")
        JaxMetricsLogger(ref).log("frame", index=3, valid_fraction=np.float32(0.5), note="x")
        got, want = jax_read_metrics(port), read_metrics(ref)
        for row in (got[0], want[0]):
            row.pop("ts")
        assert got == want == [{"event": "frame", "index": 3.0, "note": "x",
                                "valid_fraction": 0.5}]


class TestChecked:
    def test_passes_clean_fn(self):
        f = checked(lambda x: torch.sqrt(x) + 1.0)
        out = f(torch.tensor([1.0, 4.0]))
        np.testing.assert_allclose(out.numpy(), [2.0, 3.0])

    def test_raises_on_nan(self):
        f = checked(lambda x: torch.log(x))  # log(-1) -> nan
        with pytest.raises(FloatCheckError, match="log"):
            f(torch.tensor([-1.0]))

    def test_composes_with_a_wrapped_fn(self):
        f = checked(torch.no_grad()(lambda x: x / x))
        with pytest.raises(FloatCheckError):
            f(torch.tensor([0.0]))

    def test_names_a_division_by_zero(self):
        f = checked(lambda x, y: x / y)
        with pytest.raises(FloatCheckError, match="division by zero in aten.div"):
            f(torch.tensor([1.0, 2.0]), torch.tensor([1.0, 0.0]))
        assert torch.equal(f(torch.tensor([1.0]), torch.tensor([2.0])), torch.tensor([0.5]))

    def test_a_nan_carried_in_is_not_raised(self):
        f = checked(lambda x: x * 2.0, errors=("nan",))
        assert torch.isnan(f(torch.tensor([float("nan")]))).all()


class TestDeterminism:
    def test_identical_runs_pass(self):
        x = torch.linspace(0, 1, 128)
        assert_deterministic(lambda a: torch.cumsum(a * 1.0000001, 0), x, runs=3)

    def test_detects_difference_via_variant(self):
        x = torch.arange(16, dtype=torch.float32)
        with pytest.raises(AssertionError, match="nondeterministic"):
            assert_deterministic(lambda a: a, x, variants=[lambda: x + 1e-3])

    def test_two_view_pipeline_bit_deterministic(self):
        """Same inputs -> bit-identical disparity (the golden-test
        precondition)."""
        from stereovisionarray_tpu_torch.config import CostConfig, SGMConfig
        from stereovisionarray_tpu_torch.models import two_view_disparity

        rng = np.random.default_rng(0)
        base = rng.uniform(0, 255, size=(40, 72)).astype(np.float32)
        left = torch.from_numpy(base[:, :64].copy())
        right = torch.from_numpy(base[:, 8:].copy())
        cfg_c = CostConfig(num_disparities=16, census_window=(5, 5))
        cfg_s = SGMConfig(num_paths=4)
        assert_deterministic(lambda: two_view_disparity(left, right, cfg_c, cfg_s).disparity)


class _Out(NamedTuple):
    depth: object
    valid: object


class TestFindNonfinite:
    def test_reports_paths_and_counts(self):
        tree = {"ok": torch.ones(4), "bad": torch.tensor([1.0, float("nan"), float("inf")])}
        out = find_nonfinite(tree)
        assert len(out) == 1 and list(out.values()) == [2]

    def test_empty_for_clean_tree(self):
        assert find_nonfinite({"a": torch.zeros(3), "i": torch.arange(3)}) == {}

    def test_key_strings_are_the_references(self):
        """A dict of a tuple and a NamedTuple: the keys and counts
        jax.tree_util.keystr gives through the reference's find_nonfinite."""
        nan, inf = float("nan"), float("inf")
        leaves = {"a": [1.0, nan], "b0": [inf, inf, 0.0], "b1": [0.0], "d": [nan, nan, nan],
                  "v": [1.0, inf]}

        def tree(as_array):
            f = {k: as_array(np.asarray(v, np.float32)) for k, v in leaves.items()}
            return {"z": (f["b0"], f["b1"]), "a": f["a"], "out": _Out(depth=f["d"], valid=f["v"]),
                    "n": None, "i": as_array(np.arange(3))}

        want = jax_find_nonfinite(tree(jnp.asarray))
        got = find_nonfinite(tree(torch.from_numpy))
        assert got == want == {"['a']": 1, "['out'].depth": 3, "['out'].valid": 1,
                               "['z'][0]": 2}
        assert list(got) == list(want)
