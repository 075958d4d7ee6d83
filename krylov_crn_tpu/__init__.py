"""krylov_crn_tpu — a sparse second-order optimization framework for the GPU.

A from-scratch JAX/XLA/Pallas implementation of cubic-regularized Newton
methods for sparse generalized linear models, with the capabilities of the
Krylov Cubic Regularized Newton reference (Jiang et al., AISTATS 2024,
arXiv:2401.03058):

* ``data``     — LIBSVM parsing (native C fast path), CSR/COO device formats,
                 synthetic generators, nnz-balanced partitioning.
* ``ops``      — sparse matvec / transpose matvec / fused Hessian-vector
                 products, Lanczos tridiagonalization with full
                 reorthogonalization, CG, the cubic-subproblem secular solver.
* ``models``   — oracles: logistic regression (value / gradient / Hessian /
                 HVP / coordinate partials), regularizers (l1/l2 + prox).
* ``solvers``  — CRN (full & CG), Krylov CRN, SSCN, and the run-loop engine
                 with tracing, line search, convergence checks, checkpointing.
* ``parallel`` — mesh construction and shard_map-based row-partitioned
                 distribution (psum-reduced HVPs, replicated iterates).
* ``utils``    — Trace (metric logging / plotting / pickling), profiling.

Design rules that shape everything here:

1. Sparse index/value arrays are always **jit arguments** (pytree leaves),
   never closure constants — XLA constant-embedding of large gather/scatter
   index arrays falls off a performance cliff and can take minutes to
   compile.
2. Both A (row-sorted COO/CSR) and its explicit transpose are stored so each
   direction of the matvec is a gather + sorted segment-sum — no scatters.
3. Hot-loop control flow (line search, secular Newton, Lanczos, CG) is
   ``lax.while_loop``/``lax.scan`` — no host round-trips inside a step.
4. fp32 storage for the big arrays, fp64 for scalar-critical reductions
   (enable with :func:`enable_x64`) — full-fp64 on CPU for verification.
"""

__version__ = "0.1.0"

from krylov_crn_tpu.config import (  # noqa: F401
    enable_x64,
    pin_fp32_matmul_precision,
)

# fp32 algebra must be fp32: without this, XLA:GPU may run fp32 matrix
# products in TF32 (~1e-3 error; see config.py docstring), which silently
# destroys the solver's 1e-8 gap targets. Applied at import so no entry
# point (CLI, bench, tests, user code) can miss it.
pin_fp32_matmul_precision()
from krylov_crn_tpu.data.formats import SparseMatrix, DualSparse  # noqa: F401
from krylov_crn_tpu.models.logistic import LogisticRegression  # noqa: F401
from krylov_crn_tpu.solvers.krylov_crn import CubicKrylov  # noqa: F401
from krylov_crn_tpu.solvers.crn import CubicNewton  # noqa: F401
from krylov_crn_tpu.solvers.sscn import SSCN  # noqa: F401
from krylov_crn_tpu.utils.trace import Trace  # noqa: F401
