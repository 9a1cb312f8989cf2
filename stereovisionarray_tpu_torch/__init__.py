"""stereovisionarray_tpu_torch — the PyTorch / CUDA port of stereovisionarray_tpu.

The JAX package beside it is the reference; this package mirrors its layout
and names (``ops/cost_volume.py``, ``ops/sgm.py``, ``models/two_view.py``, ...)
so each module's counterpart is easy to find. Every Pallas kernel on the
ported path has a hand-written CUDA kernel for Hopper (``csrc/*.cu``, built
with nvcc at first use by ``_native.py``) next to a plain PyTorch version of
the same function:

 - a CUDA tensor launches the kernel (or raises);
 - a CPU tensor runs the plain version;
 - ``backend="torch"`` runs the plain version on any device (kernel parity
   checks on the card);
 - ``backend="xla"`` runs the plain twin of the reference's XLA oracle route
   (float scans, edge-clamped extraction) and launches no kernel.

The configuration tree (``config.py``) is a copy of the reference's, so a
reference configuration carries across as
``config.EngineConfig.from_dict(jax_cfg.to_dict())``. This package imports
neither JAX nor anything of ``stereovisionarray_tpu``.
"""

__version__ = "0.1.0"

from stereovisionarray_tpu_torch import config as config  # noqa: F401
