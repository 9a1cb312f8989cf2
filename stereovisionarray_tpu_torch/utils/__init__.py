"""Auxiliary subsystems (twin of ``stereovisionarray_tpu/utils``): checkpoint
and resume, profiling, structured metrics logging, and the numeric-safety and
determinism harness. The elastic runner (``ElasticRunner``, ``Heartbeat``,
``reshard``) reshards over a device mesh and comes with the port of
``parallel/``."""

from stereovisionarray_tpu_torch.utils.checkpoint import (  # noqa: F401
    load_checkpoint,
    save_checkpoint,
)
from stereovisionarray_tpu_torch.utils.debug import (  # noqa: F401
    assert_deterministic,
    checked,
    find_nonfinite,
)
from stereovisionarray_tpu_torch.utils.obslog import MetricsLogger  # noqa: F401
from stereovisionarray_tpu_torch.utils.profiling import (  # noqa: F401
    StageTimer,
    span,
    time_fn,
    trace,
)
