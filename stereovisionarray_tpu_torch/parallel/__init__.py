"""Streaming execution (twin of ``stereovisionarray_tpu/parallel``; the
sharded paths and ``DevicePipeline`` are not ported yet)."""

from stereovisionarray_tpu_torch.parallel.streaming import (  # noqa: F401
    StreamExecutor,
    throughput_stream,
    to_device,
)
