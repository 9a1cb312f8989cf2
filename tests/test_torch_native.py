"""The lean launch path of ``stereovisionarray_tpu_torch/_native.py`` on the
CPU: :func:`_native.check`'s refusals (device, dtype, shape, contiguity) and
their messages; :func:`_native.launch` on the current stream's raw handle,
entering a device context only for a tensor on another device, and raising
on a reported CUDA error; the kernel wrappers refusing CPU tensors under
``backend="cuda"`` before anything is built. The torch entry points of a CUDA
build and the library are stood in for, so nothing here needs a card."""

import contextlib
import types

import numpy as np
import pytest
import torch

from stereovisionarray_tpu_torch import _native
from stereovisionarray_tpu_torch.ops import extract_cuda, hatsample


def _tensor(shape=(3, 4), dtype=torch.float32, cuda=True, contiguous=True):
    """A stand-in for a CUDA tensor: the attributes check reads."""
    return types.SimpleNamespace(is_cuda=cuda, dtype=dtype, shape=torch.Size(shape),
                                 is_contiguous=lambda: contiguous,
                                 device=torch.device("cuda", 0) if cuda else torch.device("cpu"))


def test_check_accepts_a_matching_tensor():
    _native.check(_tensor(), "x", torch.float32, (3, 4))


@pytest.mark.parametrize("tensor,error,message", [
    (torch.zeros(3, 4), ValueError, "x must be a CUDA tensor, got device cpu"),
    (_tensor(cuda=False), ValueError, "x must be a CUDA tensor, got device cpu"),
    (_tensor(dtype=torch.int16), TypeError, "x must be torch.float32, got torch.int16"),
    (_tensor(shape=(4, 3)), ValueError, r"x must have shape \(3, 4\), got \(4, 3\)"),
    (_tensor(shape=(3, 4, 1)), ValueError, r"x must have shape \(3, 4\), got \(3, 4, 1\)"),
    (_tensor(contiguous=False), ValueError, "x must be contiguous"),
])
def test_check_refusals(tensor, error, message):
    with pytest.raises(error, match=f"^{message}$"):
        _native.check(tensor, "x", torch.float32, (3, 4))


@pytest.fixture
def fake_cuda(monkeypatch):
    """A loaded library of one entry point and a CUDA build's torch hooks:
    records the calls, the device contexts entered and the stream passed."""
    log = {"calls": [], "contexts": [], "current": 0, "err": 0}

    def entry(*args):
        log["calls"].append(args)
        return log["err"]

    @contextlib.contextmanager
    def device(index):
        log["contexts"].append(index)
        yield

    lib = types.SimpleNamespace(svt_error_string=lambda err: b"an error")
    monkeypatch.setattr(_native, "_lib", lib)
    monkeypatch.setattr(_native, "_FNS", {"svt_entry": entry})
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: log["current"], raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda i: 1000 + i, raising=False)
    monkeypatch.setattr(torch.cuda, "device", device)
    return log


def test_launch_on_the_current_device_enters_no_context(fake_cuda):
    _native.launch("svt_entry", torch.device("cuda", 0), 7, None, 2.5)
    assert fake_cuda["calls"] == [(7, None, 2.5, 1000)]
    assert fake_cuda["contexts"] == []


def test_launch_on_another_device_switches_to_it(fake_cuda):
    fake_cuda["current"] = 1
    _native.launch("svt_entry", torch.device("cuda", 3), 7)
    assert fake_cuda["calls"] == [(7, 1003)]  # that device's stream
    assert fake_cuda["contexts"] == [3]


def test_launch_raises_on_a_reported_error(fake_cuda):
    fake_cuda["err"] = 1
    with pytest.raises(RuntimeError, match=r"svt_entry: CUDA error 1 \(an error\)"):
        _native.launch("svt_entry", torch.device("cuda", 0))


def _maps():
    return torch.from_numpy(np.random.default_rng(0).uniform(0, 7, (4, 9)).astype(np.float32))


@pytest.mark.parametrize("call", [
    lambda: extract_cuda.extract_maps(torch.zeros(4, 9, 8, dtype=torch.int16), backend="cuda",
                                      lr_max_diff=1.0),
    lambda: extract_cuda.extract_disparity_maps(torch.zeros(4, 9, 8), lr_max_diff=1.0,
                                                backend="cuda"),
    lambda: extract_cuda.lr_gather(_maps(), _maps(), 8, backend="cuda"),
    lambda: hatsample.hat_sample(_maps(), _maps(), -2, 2, backend="cuda"),
    lambda: hatsample.hat_sample_2d(_maps(), _maps(), _maps(), -2, 2, backend="cuda"),
], ids=["K4", "K6", "K5", "K9", "K9_2d"])
def test_wrappers_refuse_cpu_tensors_before_building(monkeypatch, call):
    monkeypatch.setattr(_native, "build", lambda force=False: pytest.fail("built"))
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        call()
