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
   checks on the card).

The configuration tree is the reference's own: ``stereovisionarray_tpu.config``
is stdlib-only, so importing it pulls in no JAX. This package never imports
JAX.
"""

__version__ = "0.1.0"

from stereovisionarray_tpu import config as config  # noqa: F401
