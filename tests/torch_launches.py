"""The C entry points a call launches, seen by a spy on ``_native.launch``.

The kernels' wrappers keep no counts: a test asks which entry points ran,
in which order and with which arguments. On the CPU a wrapper launches
nothing, so the list stays empty.
"""

import pytest

from stereovisionarray_tpu_torch import _native


class Launches(list):
    """Entry-point names in launch order; ``args[i]`` holds the i-th launch's
    arguments after its device."""

    def __init__(self):
        super().__init__()
        self.args = []

    def clear(self):
        super().clear()
        self.args.clear()

    def of(self, name):
        """The arguments of each launch of `name`, in order."""
        return [a for n, a in zip(self, self.args) if n == name]


@pytest.fixture
def launched(monkeypatch):
    """The C entry points launched through ``_native.launch``, in order."""
    seen = Launches()
    real = _native.launch

    def spy(name, device, *args):
        seen.append(name)
        seen.args.append(args)
        return real(name, device, *args)

    monkeypatch.setattr(_native, "launch", spy)
    return seen
