"""Measure the large-n stress config (BASELINE.md:31) on the GPU.

The Gram path is O(n^2) memory and caps at n ~ 45k; beyond that the only
single-device path is the gather-based COO path, bound by its gather and
segment-sum rates. This tool produces the number for the "stress-1m"
config (1M x 1M, 100M nnz power-law,
data/synthetic.py): fused-HVP throughput in nnz/s, plus the gather-width
amortization curve that quantifies how much an SpMM (multi-vector) variant
recovers.

Methodology notes:
  * the stress matrix is generated ON DEVICE (jax PRNG + device sort):
    shipping 2x 1.2 GB of COO arrays from the host would be set-up
    that says nothing about the device. Power-law columns come from an
    inverse-CDF transform of uniforms — same Zipf-like tail as
    data/synthetic.powerlaw_sparse, no host-side rng.choice.
  * timing per PERF.md: chained data-dependent iterations inside one
    program, scalar fetched, difference of two chain lengths.
  * the 10M x 10M / 1B-nnz config needs ~24 GB of COO (+ transpose) per
    copy and is a multi-GPU (row-sharded, parallel/sharded.py) target;
    this tool reports the per-device building block the sharded path
    replicates.

Run:  python tools/measure_large_n.py [--n 1000000] [--nnz 100000000]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def device_powerlaw_coo(n, d, nnz, alpha=1.1, seed=0):
    """(rows, cols, vals) on device; rows sorted (row-sorted COO).

    Columns follow a truncated Pareto rank distribution: for u ~ U(0,1),
    col = floor(exp(u * log(d+1))) - 1 has P(col = k) ~ 1/(k+1) — the
    alpha=1 Zipf tail (close enough to synthetic.powerlaw_sparse's
    alpha=1.1 for bandwidth purposes; what matters for the gather is the
    skewed reuse pattern)."""
    k0, k1, k2 = jax.random.split(jax.random.PRNGKey(seed), 3)
    rows = jax.random.randint(k0, (nnz,), 0, n, dtype=jnp.int32)
    rows = jnp.sort(rows)
    u = jax.random.uniform(k1, (nnz,), jnp.float32)
    cols = jnp.exp(u * np.log(float(d) + 1.0)).astype(jnp.int32) - 1
    cols = jnp.clip(cols, 0, d - 1)
    vals = jax.random.normal(k2, (nnz,), jnp.float32)
    return rows, cols, vals


def build_device_dual(n, d, nnz, seed=0):
    """DualSparse with both orientations built on device."""
    from krylov_crn_tpu.data.formats import DualSparse, SparseMatrix

    rows, cols, vals = device_powerlaw_coo(n, d, nnz, seed=seed)
    a = SparseMatrix(vals=vals, rows=rows, cols=cols, n=n, d=d, nnz=nnz)
    # transpose: stable-sort by column; at-rows = old cols, at-cols = rows
    order = jnp.argsort(cols, stable=True)
    at = SparseMatrix(vals=vals[order], rows=cols[order], cols=rows[order],
                      n=d, d=n, nnz=nnz)
    at_indptr = jnp.searchsorted(at.rows, jnp.arange(d + 1,
                                                     dtype=jnp.int32))
    return DualSparse(a=a, at=at, at_indptr=at_indptr.astype(jnp.int32),
                      dense=None, max_col_nnz=0)


def measure_hvp(data, k1=1, k2=4, reps=3):
    from krylov_crn_tpu.ops.spmv import hvp_sparse
    from krylov_crn_tpu.utils.profiling import device_time_per_call

    w = jnp.ones((data.n,), jnp.float32)

    def make_chained(k):
        @jax.jit
        def f(data, w, v):
            # data MUST be a jit argument: closure-captured COO arrays
            # embed as jaxpr constants (2.4 GB here) and fall off the
            # known ~800x compile/codegen cliff (package rule 1)
            def body(v, _):
                v = hvp_sparse(data, w, v)
                return v / jnp.linalg.norm(v), ()
            v, _ = jax.lax.scan(body, v, None, length=k)
            return v[0]
        return f

    v0 = jnp.ones((data.d,), jnp.float32)
    sec = device_time_per_call(make_chained, (data, w, v0), k1=k1, k2=k2,
                               reps=reps)
    return sec


def measure_gather_width(nnz, d, widths=(1, 2, 4, 8, 16), seed=1):
    """Effective gathered elem/s vs row width: quantifies how much an
    SpMM (multi-RHS) amortizes the scalar index-generation bound."""
    from krylov_crn_tpu.utils.profiling import device_time_per_call

    idx = jax.random.randint(jax.random.PRNGKey(seed), (nnz,), 0, d,
                             jnp.int32)
    out = {}
    for wdt in widths:
        tbl = jax.random.normal(jax.random.PRNGKey(seed + wdt),
                                (d, wdt), jnp.float32)

        def make_chained(k, tbl=tbl):
            @jax.jit
            def f(tbl, idx):
                def body(s, _):
                    g = tbl[idx] + s  # (nnz, wdt) gather
                    s = jnp.sum(g[:, :1]) * 1e-20
                    return s, ()
                s, _ = jax.lax.scan(body, jnp.float32(0.0), None, length=k)
                return s
            return f

        sec = device_time_per_call(make_chained, (tbl, idx), k1=1, k2=4)
        out[wdt] = nnz * wdt / sec / 1e9  # G elem/s
    return out


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=1_000_000)
    p.add_argument("--d", type=int, default=1_000_000)
    p.add_argument("--nnz", type=int, default=100_000_000)
    p.add_argument("--widths", action="store_true",
                   help="also measure the gather-width amortization curve")
    args = p.parse_args()

    t0 = time.perf_counter()
    data = build_device_dual(args.n, args.d, args.nnz)
    jax.block_until_ready(data.at.vals)
    build_s = time.perf_counter() - t0

    sec = measure_hvp(data)
    res = {
        "config": f"{args.n}x{args.d}, {args.nnz} nnz (device power-law)",
        "device_build_s": round(build_s, 2),
        "hvp_s": round(sec, 4),
        "hvp_gnnz_per_s": round(2 * args.nnz / sec / 1e9, 4),
        "spmv_gnnz_per_s": round(args.nnz / (sec / 2) / 1e9, 4),
    }
    if args.widths:
        res["gather_gelem_per_s_by_width"] = {
            str(k): round(v, 4)
            for k, v in measure_gather_width(min(args.nnz, 50_000_000),
                                             args.d).items()}
    print(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
