"""Run records: checkpoint log, metric series, gap curves, persistence.

Fills the role of the reference Trace (/root/reference/optimizer/
opt_trace.py:19-120) with a different organization built for the device
runtime:

* checkpoints (``xs``) may be explicit iterates *or* compact solver pytrees
  (the Gram solvers' (gamma, zeta, Ax) reps) — a solver-installed
  ``materializer`` converts reps to iterates on demand;
* ``metrics`` holds full-resolution per-iteration series produced on device
  (the fused runner syncs them at chunk boundaries) — the reference can only
  subsample through its host loop (optimizer.py:136-145);
* loss evaluation over checkpoints can run at a chosen precision
  (``evaluate_losses(dtype=...)``), giving the fp64 verification pass of
  BASELINE.md's convergence-parity row;
* pickling keeps the checkpoint pytrees (host numpy) and drops live loss
  handles, re-attached on load.
"""

from __future__ import annotations

import os
import pickle
import warnings
from pathlib import Path

import numpy as np

__all__ = ["Trace"]


class Trace:
    """One optimizer run's record."""

    def __init__(self, loss=None, label=None):
        self.loss = loss
        self.label = label
        self.xs = []  # checkpoints: iterates or solver rep pytrees
        self.ts = []  # wall-clock stamps (s)
        self.its = []  # iteration counters
        self.loss_vals = []  # f at checkpoints (or full-res when fused)
        self.solver_its = None  # cumulative inner-solver iterations
        self.ls_its = None  # optional line-search-iteration axis
        self.metrics = {}  # full-resolution device-synced series
        self.its_converted_to_epochs = False
        self.materializer = None  # rep -> iterate converter (Gram solvers)

    # ------------------------- checkpoint access -------------------------

    def _materialize(self, ck):
        """Explicit iterate for a checkpoint; converts rep pytrees through
        the installed materializer, passes arrays straight through."""
        if self.materializer is not None and not hasattr(ck, "shape"):
            return self.materializer(ck)
        return ck

    def iterates(self):
        """All checkpoints as explicit iterates (may cost one transpose
        SpMV per rep checkpoint)."""
        return [self._materialize(ck) for ck in self.xs]

    # --------------------------- loss curves ----------------------------

    def evaluate_losses(self, dtype=None, force=False):
        """f at every stored checkpoint via the attached oracle.

        ``dtype``: evaluate in this precision regardless of the solver's
        (e.g. np.float64 for the host verification pass — iterates are
        materialized and upcast before the oracle call). With the default
        None, the oracle's own dtype is used. No-op if values exist unless
        ``force``."""
        if len(self.loss_vals) and not force:
            warnings.warn("trace already has loss values; pass force=True "
                          "or clear .loss_vals to re-evaluate")
            return np.asarray(self.loss_vals)
        if self.loss is None:
            raise ValueError("no oracle attached to this trace")
        vals = []
        for ck in self.xs:
            x = self._materialize(ck)
            if dtype is not None:
                x = np.asarray(x, dtype)
            vals.append(self.loss.value(x))
        self.loss_vals = np.asarray(vals)
        return self.loss_vals

    def compute_loss_of_iterates(self):
        """Reference-API alias (opt_trace.py:39-43 semantics)."""
        self.evaluate_losses()

    @property
    def best_loss_value(self):
        if not len(self.loss_vals):
            self.evaluate_losses()
        return float(np.min(self.loss_vals))

    def gap_curve(self, f_opt=None):
        """Suboptimality gaps f(x_k) - f* over the stored curve."""
        if not len(self.loss_vals):
            self.evaluate_losses()
        if f_opt is None:
            f_opt = self.loss.f_opt
        return np.asarray(self.loss_vals, np.float64) - float(f_opt)

    # ------------------------------ axes --------------------------------

    def convert_its_to_epochs(self, batch_size=1):
        if self.its_converted_to_epochs:
            warnings.warn("iteration axis is already in epochs")
            return
        self.its = np.asarray(self.its) / (self.loss.n / batch_size)
        self.its_converted_to_epochs = True

    def _xaxis(self, time, use_ls_its):
        """Pick the x-axis: solver-iteration axis > wall-clock > its.

        ``ls_its`` mirrors the reference's cumulative line-search/solver
        iteration axis (opt_trace.py:62-66); our solvers record the same
        quantity as ``solver_its`` (cubic.py:230-235 semantics), which
        serves as the axis when no explicit ls_its was set."""
        axis = self.ls_its if self.ls_its is not None else self.solver_its
        if use_ls_its and axis is not None and len(axis) == len(self.its):
            print(f"[trace] {self.label}: plotting against the solver-"
                  f"iteration axis")
            return axis
        return self.ts if time else self.its

    # ----------------------------- plotting -----------------------------

    def plot_losses(self, its=None, f_opt=None, label=None, markevery=None,
                    use_ls_its=True, time=False, *args, **kwargs):
        """Gap curve f(x)-f* on the current matplotlib axes."""
        import matplotlib.pyplot as plt

        xs = self._xaxis(time, use_ls_its) if its is None else its
        ys = self.gap_curve(f_opt)
        if markevery is None:
            markevery = max(1, len(ys) // 20)
        plt.plot(xs, ys, label=self.label if label is None else label,
                 markevery=markevery, *args, **kwargs)
        plt.ylabel(r"$f(x)-f^*$")

    def plot_distances(self, its=None, x_opt=None, label=None,
                       markevery=None, use_ls_its=True, time=False,
                       *args, **kwargs):
        """Squared iterate distances ||x - x*||^2."""
        import matplotlib.pyplot as plt

        xs = self._xaxis(time, use_ls_its) if its is None else its
        if x_opt is None:
            x_opt = getattr(self.loss, "x_opt", None)
            if x_opt is None:
                x_opt = self._materialize(self.xs[-1])
        ref = np.asarray(x_opt, np.float64)
        ys = [float(np.sum((np.asarray(self._materialize(ck), np.float64)
                            - ref) ** 2)) for ck in self.xs]
        if markevery is None:
            markevery = max(1, len(ys) // 20)
        plt.plot(xs, ys, label=self.label if label is None else label,
                 markevery=markevery, *args, **kwargs)
        plt.ylabel(r"$\Vert x-x^*\Vert^2$")

    # ---------------------------- persistence ---------------------------

    def save(self, file_name, path="./results/"):
        """Pickle to ``path/file_name``: checkpoints pulled to host numpy
        (pytree structure preserved), live loss handles dropped. A
        materializer that carries its own loss reference (RepMaterializer)
        is kept with the reference nulled; from_pickle re-attaches it."""
        import jax

        keep_loss, keep_mat, keep_xs = self.loss, self.materializer, self.xs
        try:
            self.loss = None
            if hasattr(keep_mat, "loss"):
                keep_mat.loss = None
            else:
                self.materializer = None  # unpicklable bound converter
            self.xs = [jax.tree.map(np.asarray, ck) for ck in keep_xs]
            Path(path).mkdir(parents=True, exist_ok=True)
            with open(os.path.join(path, file_name), "wb") as fh:
                pickle.dump(self, fh)
        finally:
            self.loss = keep_loss
            self.materializer = keep_mat
            if hasattr(keep_mat, "loss"):
                keep_mat.loss = keep_loss
            self.xs = keep_xs

    @classmethod
    def from_pickle(cls, path, loss=None):
        if not os.path.isfile(path):
            return None
        with open(path, "rb") as fh:
            trace = pickle.load(fh)
        trace.loss = loss
        mat = getattr(trace, "materializer", None)
        if mat is not None and hasattr(mat, "loss"):
            mat.loss = loss
        if loss is not None and len(trace.loss_vals):
            # the reference's from_pickle reads best_loss_value off the
            # *class* (opt_trace.py:119, latent bug); this uses the loaded
            # instance and folds it into the oracle's running best
            loss.f_opt = min(trace.best_loss_value, loss.f_opt)
        return trace
