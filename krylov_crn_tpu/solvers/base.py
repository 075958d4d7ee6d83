"""Optimizer run-loop engine.

Mirrors the reference's Optimizer base (/root/reference/optimizer/
optimizer.py:17-172): multi-seed runs, wall-clock / iteration / iterate-diff
convergence, trace subsampling that always keeps the first
``save_first_iterations`` checkpoints then thins by progress fraction
(optimizer.py:136-145), and post-run loss evaluation.

Device-native difference: ``step()`` dispatches a single jitted device program
over a solver-state pytree (no host round-trips inside a step; line search,
secular Newton and Lanczos are lax loops inside it). The host loop only
reads back scalars for convergence/trace bookkeeping. The iterate-diff
tolerance is computed on device during the step and carried in the state.
"""

from __future__ import annotations

import time
from typing import Any

import jax.numpy as jnp
import numpy as np

from krylov_crn_tpu.utils.trace import Trace

__all__ = ["Optimizer"]


class Optimizer:
    def __init__(self, loss, trace_len=200, tolerance=0,
                 save_first_iterations=5, label=None, seeds=None, tqdm=True,
                 store_iterates=True):
        self.loss = loss
        self.trace_len = trace_len
        self.tolerance = tolerance
        self.save_first_iterations = save_first_iterations
        self.label = label
        self.tqdm = tqdm
        self.store_iterates = store_iterates

        self.initialized = False
        self.trace = Trace(loss=loss, label=label)
        self.seeds = [42] if seeds is None else seeds
        self.finished_seeds = []
        self.state: Any = None

    # -- subclass hooks -------------------------------------------------
    def init_state(self, x0, seed):  # pragma: no cover - abstract
        raise NotImplementedError

    def step(self):  # pragma: no cover - abstract
        raise NotImplementedError

    # -- engine ---------------------------------------------------------
    def run(self, x0, t_max=np.inf, it_max=np.inf):
        if t_max is np.inf and it_max is np.inf:
            it_max = 100
            print(f"{self.label}: The number of iterations is set to "
                  f"{it_max}.")
        self.t_max = t_max
        self.it_max = it_max

        for seed in self.seeds:
            if seed in self.finished_seeds:
                continue
            if len(self.seeds) > 1:
                print(f"{self.label}: Running seed {seed}")
            self.rng = np.random.default_rng(seed)
            if not self.initialized:
                self.init_run(x0, seed)
                self.initialized = True

            it_criterion = self.it_max is not np.inf
            total = self.it_max if it_criterion else self.t_max
            shown = 0  # tenths of the budget already reported
            while not self.check_convergence():
                self.step()
                self.save_checkpoint()
                if self.tqdm:
                    done = self.it if it_criterion else self.t
                    tenth = int(10 * done / total)
                    if tenth > shown:
                        shown = tenth
                        print(f"{self.label}: it {self.it}, "
                              f"{self.t:.1f} s ({10 * tenth}%)", flush=True)
            self.finished_seeds.append(seed)
            self.initialized = False
            # fold the device-tracked running-best value into the oracle's
            # empirical-f* tracker (reference loss.py:66-73 semantics);
            # two-float states contribute full pair precision
            if hasattr(self.state, "f_best"):
                f_best = (float(self.state.f_best)
                          + float(getattr(self.state, "f_best_lo", 0.0)))
                if f_best < self.loss.f_opt:
                    self.loss.f_opt = f_best
                    self.loss.x_opt = self.current_x()
        return self.trace

    def warm(self, x0, seed=42):
        """Execute one throwaway step so the step program's one-time
        costs (XLA compile, persistent-cache deserialization, per-process
        executable load — seconds to minutes) land OUTSIDE a subsequent
        timed ``run``. Without this, a
        time-budgeted run can burn its entire ``t_max`` inside the first
        step's compile and stop after one iteration (observed: the w8a
        dense-CRN Figure-2 leg terminating at it=1 with a 240 s budget).
        The real ``run`` re-initializes from scratch."""
        self.rng = np.random.default_rng(seed)
        self.init_run(x0, seed)
        saved_metrics = {k: list(v) for k, v in self.trace.metrics.items()}
        self.step()
        st = self.state
        float(getattr(st, "value", getattr(st, "grad_norm", 0.0)))
        # steps that write trace metrics (GramCRN's exact-value stream)
        # must not leak the throwaway iteration into the real run
        self.trace.metrics = saved_metrics
        self.initialized = False

    def current_x(self):
        """The current iterate as an explicit vector (or None).

        Solvers whose state carries a compact representation instead of
        x (the Gram family: gamma/zeta) override this to materialize it,
        so ``loss.x_opt`` — which the reference tracks as the argmin
        iterate (loss.py:66-73) and plot_distances consumes
        (opt_trace.py:74-94) — is populated on every solver path."""
        return getattr(self.state, "x", None)

    def check_convergence(self):
        no_it_left = self.it >= self.it_max
        no_time_left = time.perf_counter() - self.t_start >= self.t_max
        tolerance_met = False
        if self.tolerance > 0 and self.it > 0:
            # device-computed ||x_new - x_old|| from the last step
            tolerance_met = float(self.state.diff_norm) < self.tolerance
        return no_it_left or no_time_left or tolerance_met

    def init_run(self, x0, seed):
        x0 = jnp.asarray(x0)
        self.dim = x0.shape[0]
        self.state = self.init_state(x0, seed)
        self.trace.xs = [x0] if self.store_iterates else []
        self.trace.its = [0]
        self.trace.ts = [0]
        if not self.store_iterates:
            self.trace.loss_vals = [float(self.loss.value(x0))]
        self.it = 0
        self.t = 0
        self.t_start = time.perf_counter()
        self.time_progress = 0
        self.iterations_progress = 0
        self.max_progress = 0

    def should_update_trace(self):
        if self.it <= self.save_first_iterations:
            return True
        span = self.trace_len - self.save_first_iterations
        self.time_progress = int(span * self.t / self.t_max)
        self.iterations_progress = int(span * (self.it / self.it_max))
        return max(self.time_progress, self.iterations_progress) > \
            self.max_progress

    def save_checkpoint(self):
        self.it += 1
        self.t = time.perf_counter() - self.t_start
        if self.should_update_trace():
            self.update_trace()
        self.max_progress = max(self.time_progress, self.iterations_progress)

    def update_trace(self):
        if self.store_iterates:
            self.trace.xs.append(self.state.x)
        else:
            self.trace.loss_vals = list(self.trace.loss_vals)
            self.trace.loss_vals.append(
                float(self.state.value)
                + float(getattr(self.state, "value_lo", 0.0)))
        self.trace.ts.append(self.t)
        self.trace.its.append(self.it)

    def compute_loss_of_iterates(self):
        self.loss.reset()
        self.trace.compute_loss_of_iterates()

    def reset(self, loss):
        self.initialized = False
        self.trace = Trace(loss=loss, label=self.label)
        self.finished_seeds = []
        self.state = None
