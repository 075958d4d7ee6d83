"""Experiment driver: the reference's cubic_newton.py re-built on this
framework (flags, run grid, empirical-f* protocol and figures all mirror
the reference's cubic_newton.py:14-161).

Usage:
    python -m krylov_crn_tpu.cli --dataset w8a --it_max 100
    python -m krylov_crn_tpu.cli --dataset rcv1_train.binary --plot_time \
        --it_max 50000 --time_max 60 --SSCN_dim 10 50 100 500
    python -m krylov_crn_tpu.cli --dataset rcv1-like --synthetic ...

Additions over the reference CLI: --synthetic (no-egress stand-ins shaped
like the LIBSVM grid), --dtype, --l2, --allow-download, --mesh N (shard the
problem over N devices).
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description="Cubic Regularized Newton Methods")
    p.add_argument("--dataset", metavar="DATASETS", default="w8a", type=str,
                   help="LIBSVM dataset name, local path, or synthetic name")
    p.add_argument("--plot_time", dest="plot_time", action="store_true",
                   help="Plot with respect to time")
    p.add_argument("--it_max", default=50000, type=int, metavar="IT",
                   help="max iteration")
    p.add_argument("--time_max", default=60, type=float, metavar="T",
                   help="max time")
    p.add_argument("--SSCN_dim", nargs="+", default=10, type=int,
                   metavar="D", help="Subspace dimensions of SSCN")
    # additions over the reference CLI
    p.add_argument("--synthetic", action="store_true",
                   help="use a synthetic stand-in shaped like the dataset")
    p.add_argument("--krylov_dim", default=10, type=int,
                   help="Krylov subspace dimension m")
    p.add_argument("--l2", default=0.0, type=float)
    p.add_argument("--dtype", default=None, choices=[None, "float32",
                                                     "float64"])
    p.add_argument("--allow-download", action="store_true")
    p.add_argument("--mesh", default=0, type=int,
                   help="shard rows over N devices (0 = single device)")
    p.add_argument("--no-bench-run", action="store_true",
                   help="skip the 5x-budget benchmark run used for f*")
    import argparse as _ap

    p.add_argument("--fused", action=_ap.BooleanOptionalAction,
                   default=True,
                   help="run Gram solvers chunk-fused on device: "
                        "full-resolution loss trace, host sync + exact "
                        "fp64 boundary corrections once per chunk. The "
                        "default — the step-for-step run() path has no "
                        "boundary corrections, so fp32 runs accumulate "
                        "step-sized margin drift and cannot certify the "
                        "1e-9 grid tolerances (--no-fused to compare)")
    p.add_argument("--solver", default="auto",
                   choices=["auto", "gram", "coo"],
                   help="compute path: gram = dense-K formulation "
                        "(n <= ~45k), coo = sparse gather path, auto = "
                        "pick per problem shape")
    p.add_argument("--out-dir", default="figs")
    p.add_argument("--results-dir", default=None,
                   help="pickle traces into this directory")
    return p


_SYNTH_ALIASES = {
    "w8a": "w8a-like",
    "rcv1_train.binary": "rcv1-like",
    "news20.binary": "news20-like",
}


def load_dataset(args):
    """Returns (A_csr, b) honoring --synthetic and local files."""
    from krylov_crn_tpu.data.libsvm import load_libsvm
    from krylov_crn_tpu.data.synthetic import DATASET_SHAPES, synthetic_logreg

    name = args.dataset
    key = name if name in DATASET_SHAPES else _SYNTH_ALIASES.get(name)
    if args.synthetic:
        if key is None:
            raise SystemExit(f"no synthetic stand-in for {name!r}; "
                             f"choices: {sorted(DATASET_SHAPES)}")
        print(f"[cli] using synthetic stand-in for {name} ({key})")
        return synthetic_logreg(key, seed=0)
    if key in DATASET_SHAPES and not os.path.exists(name):
        try:
            return load_libsvm(name, allow_download=args.allow_download)
        except FileNotFoundError:
            print(f"[cli] {name} not found locally and downloads disabled; "
                  f"falling back to synthetic stand-in ({key})")
            return synthetic_logreg(key, seed=0)
    return load_libsvm(name, allow_download=args.allow_download)


def _require_plotting():
    """The figures need matplotlib (seaborn optional): fail before any
    work instead of after every solver has run."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        raise SystemExit("krylov_crn_tpu.cli draws its figures with "
                         "matplotlib, which is not installed") from None


def main(argv=None):
    args = build_parser().parse_args(argv)
    _require_plotting()

    m_list = args.SSCN_dim
    if isinstance(m_list, int):
        m_list = [m_list]

    A, b = load_dataset(args)
    n, dim = A.shape
    print(f"[cli] {args.dataset}: n={n:,} d={dim:,} nnz={A.nnz:,}")

    from krylov_crn_tpu.models.logistic import LogisticRegression
    from krylov_crn_tpu.solvers import SSCN, CubicKrylov, CubicNewton
    from krylov_crn_tpu.solvers.crn_gram import GramCRN
    from krylov_crn_tpu.solvers.krylov_gram import GramKrylov

    dtype = args.dtype and np.dtype(args.dtype)
    # Gram path: dense n x n K fits and beats gather-bound sparse kernels
    # (see PERF.md); COO path otherwise.
    use_gram = args.solver == "gram" or (
        args.solver == "auto" and n <= 45056 and n <= 4 * dim)
    mesh = None
    if args.mesh:
        from krylov_crn_tpu.parallel.mesh import make_mesh

        mesh = make_mesh(args.mesh)

    if mesh is not None and not use_gram:
        from krylov_crn_tpu.parallel.sharded import build_sharded_dual

        data = build_sharded_dual(A, mesh, dtype=dtype or np.float32)
        loss = LogisticRegression(data, b, l2=args.l2, dtype=dtype)
        # sharded partials exist (parallel/sharded.sharded_gather_columns,
        # round 5) on this same oracle; a second instance would only
        # duplicate the f* = min(f_opt, f_opt_csc) bookkeeping
        loss_csc = loss
    else:
        loss = LogisticRegression(A, b, l2=args.l2, dtype=dtype)
        # the reference builds a CSC copy for SSCN (cubic_newton.py:55-59);
        # our DualSparse already stores the transpose, so one more oracle
        # instance only serves the f* = min(f_opt, f_opt_csc) protocol
        loss_csc = LogisticRegression(loss.data, b, l2=args.l2, dtype=dtype)
        loss_csc.A_host = getattr(loss, "A_host", None)

    x0 = np.ones(dim) * 0.5
    it_max, time_max = args.it_max, args.time_max

    # ---- algorithms (constructor grid of cubic_newton.py:63-88) ----
    memory_size = args.krylov_dim
    krylov_cls = GramKrylov if use_gram else CubicKrylov
    krylov_kw = dict(mesh=mesh) if use_gram else {}
    print(f"[cli] solver path: {'gram' if use_gram else 'coo'}"
          + (f" (mesh={args.mesh})" if mesh is not None else ""))
    cub_krylov = krylov_cls(loss=loss, reg_coef=1e-3,
                            label=f"Krylov CRN (m = {memory_size})",
                            subspace_dim=memory_size, tolerance=1e-9,
                            **krylov_kw)
    memory_size_bench = 2 * memory_size
    cub_krylov_bench = krylov_cls(
        loss=loss, reg_coef=1e-3,
        label=f"Benchmark Krylov CRN (m = {memory_size_bench})",
        subspace_dim=memory_size_bench, tolerance=1e-9, **krylov_kw)
    cubic_solver = "full" if dim < 500 else "CG"
    if cubic_solver == "CG" and use_gram:
        cub_root = GramCRN(loss=loss, reg_coef=1e-3, label="CRN",
                           tolerance=1e-8, **krylov_kw)
    else:
        cub_root = CubicNewton(loss=loss, reg_coef=1e-3, label="CRN",
                               cubic_solver=cubic_solver, tolerance=1e-8)
    # SSCN runs on both the single-device and the row-sharded COO path
    # since round 5 (sharded coordinate-panel gathers,
    # parallel/sharded.sharded_gather_columns)
    sscn_list = [
        SSCN(loss=loss_csc, reg_coef=1e-3, label=f"SSCN (m = {m})",
             subspace_dim=m, tolerance=1e-9)
        for m in m_list
    ]

    # ---- run grid (cubic_newton.py:91-111) ----
    print(f"Running optimizer: {cub_root.label}")
    cub_root.run(x0=x0, it_max=it_max, t_max=time_max)
    cub_root.compute_loss_of_iterates()
    time_max = max(cub_root.trace.ts[-1], time_max)

    for alg in sscn_list:
        print(f"Running optimizer: {alg.label}")
        alg.run(x0=x0, it_max=it_max, t_max=time_max)
        alg.compute_loss_of_iterates()

    fused = args.fused and use_gram
    if args.fused and not use_gram:
        print("[cli] --fused requires the gram solver path; ignoring")

    print(f"Running optimizer: {cub_krylov.label}")
    if fused:
        cub_krylov.run_fused(x0, it_max=it_max, t_max=time_max)
    else:
        cub_krylov.run(x0=x0, it_max=it_max, t_max=time_max)
        cub_krylov.compute_loss_of_iterates()

    if not args.no_bench_run:
        print(f"Running optimizer: {cub_krylov_bench.label}")
        if fused:
            cub_krylov_bench.run_fused(x0, it_max=5 * it_max,
                                       t_max=5 * time_max)
        else:
            cub_krylov_bench.run(x0=x0, it_max=5 * it_max,
                                 t_max=5 * time_max)
            cub_krylov_bench.compute_loss_of_iterates()

    if args.results_dir:
        for alg in [cub_root, cub_krylov, *sscn_list]:
            alg.trace.save(f"{alg.label}.pkl", path=args.results_dir)

    # ---- plotting (cubic_newton.py:113-161) ----
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    try:
        import seaborn as sns

        sns.set_style("ticks")
        sns.set_palette("colorblind")
    except ImportError:
        pass
    color_cycle = plt.rcParams["axes.prop_cycle"].by_key()["color"]
    plt.rcParams["pdf.fonttype"] = 42
    plt.rcParams["ps.fonttype"] = 42
    for k, v in [("font", 10), ("axes", 12), ("xtick", 10), ("ytick", 10),
                 ("legend", 10), ("figure", 14)]:
        if k == "font":
            plt.rc(k, size=v)
        elif k in ("axes",):
            plt.rc(k, titlesize=v, labelsize=v)
        elif k == "figure":
            plt.rc(k, titlesize=v)
        else:
            plt.rc(k, labelsize=v) if k in ("xtick", "ytick") else \
                plt.rc(k, fontsize=v)

    f_opt = min(loss.f_opt, loss_csc.f_opt)
    cub_root.trace.plot_losses(marker="o", markersize=5, f_opt=f_opt,
                               time=args.plot_time)
    for alg in sscn_list:
        alg.trace.plot_losses(marker="^", markersize=6, f_opt=f_opt,
                              time=args.plot_time)
    cub_krylov.trace.plot_losses(marker="v", markersize=6, f_opt=f_opt,
                                 time=args.plot_time,
                                 color=color_cycle[7 % len(color_cycle)])
    plt.xlabel("Time (s)" if args.plot_time else "Iteration")
    plt.yscale("log")
    plt.legend()
    plt.grid()
    plt.title("{} ($n={:,}$, $d={:,}$)".format(args.dataset, n, dim))

    os.makedirs(args.out_dir, exist_ok=True)
    mode = "time" if args.plot_time else "iteration"
    # basename so a local-path --dataset doesn't nest inside out_dir
    out = os.path.join(args.out_dir,
                       f"{mode}_{os.path.basename(args.dataset)}.pdf")
    plt.savefig(out)
    print(f"[cli] saved {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
