"""Collective accounting of the row-sharded solver steps (BASELINE.md:29).

Counts the collective operations and bytes per solver step from the
*compiled* programs on an 8-virtual-device CPU mesh (GSPMD inserts the
same collectives it would on a GPU mesh — the fake mesh is the standard
JAX idiom for this) and the per-device local K bytes per matvec from the
array shapes. Times come only from the cards: chip_smoke.py --four-gpu
runs the row-sharded race on four GPUs.

Run:  python tools/scaling_evidence.py         (prints one JSON object)
The pytest twin of the psum-count assertion lives in
tests/test_parallel.py::test_one_psum_per_hvp.
"""

from __future__ import annotations

import json
import os
import re
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8").strip()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np


def collective_stats(hlo_text: str):
    """Count collectives and their payload bytes in optimized HLO.

    Handles both single-shape results (``= f32[47240]{0} all-reduce(``)
    and TUPLE results (``= (f32[], f32[]) all-reduce(``) — compensated
    (hi, lo) pair reductions lower to tuple-shaped all-reduces which a
    single-shape regex silently drops (round-3's "1 all-reduce per Gram
    step" was exactly this undercount; the true count is ~19, all
    scalar/small combines)."""
    stats = {}
    pat = re.compile(
        r"= (\([^)]*\)|\w+\[[0-9,]*\][^ ]*) (all-reduce|all-gather|"
        r"reduce-scatter|collective-permute|all-to-all)\(")
    dt_bytes = {"f32": 4, "bf16": 2, "f64": 8, "s32": 4, "u32": 4,
                "pred": 1, "f16": 2, "s64": 8}

    def shape_bytes(sh):
        m = re.match(r"(\w+?)\[([0-9,]*)\]", sh)
        if m is None:
            return 0
        dt, dims = m.group(1), m.group(2)
        elems = 1
        for d in dims.split(","):
            if d:
                elems *= int(d)
        return elems * dt_bytes.get(dt, 4)

    for shape, op in pat.findall(hlo_text):
        if shape.startswith("("):
            # tuple result: sum the component shapes (dims contain ","
            # too, so find bracketed pieces instead of splitting)
            b = sum(shape_bytes(p) for p in
                    re.findall(r"\w+\[[0-9,]*\][^ ,)]*", shape))
        else:
            b = shape_bytes(shape)
        ent = stats.setdefault(op, {"count": 0, "bytes": 0})
        ent["count"] += 1
        ent["bytes"] += b
    return stats


def coo_path():
    """Sharded-COO fused HVP: expect exactly ONE all-reduce (psum) of the
    d-vector per HVP — the design invariant of SURVEY.md §2.2."""
    from jax.sharding import Mesh

    from krylov_crn_tpu.data.synthetic import synthetic_logreg
    from krylov_crn_tpu.ops.spmv import hvp_sparse
    from krylov_crn_tpu.parallel.mesh import DATA_AXIS
    from krylov_crn_tpu.parallel.sharded import (
        build_sharded_dual,
        pad_rowvec,
    )

    A, b = synthetic_logreg((512, 640, 4096), seed=5)
    mesh = Mesh(np.array(jax.devices()[:8]), (DATA_AXIS,))
    sd = build_sharded_dual(A, mesh)
    w = pad_rowvec(np.abs(np.random.default_rng(0).standard_normal(512)),
                   sd)
    v = jnp.ones((sd.d,), jnp.float32)

    fn = jax.jit(lambda w, v: hvp_sparse(sd, w, v))
    hlo = fn.lower(w, v).compile().as_text()
    st = collective_stats(hlo)
    d_bytes = sd.d * 4
    return {
        "program": "sharded_hvp (COO fallback path)",
        "collectives": st,
        "d_vector_bytes": d_bytes,
        "one_psum_per_hvp": st.get("all-reduce", {}).get("count") == 1,
        "local_bytes_per_device": int(3 * (sd.a_vals.shape[0] // 8) * 4 * 2),
    }


def _parse_computations(hlo: str):
    """Split optimized HLO text into named computations (braces-scoped);
    returns {name: [instruction lines]}."""
    comps, cur, name = {}, None, None
    for line in hlo.splitlines():
        m = re.match(r"^(?:ENTRY )?%?([\w.\-]+) \(.*\) -> .* \{", line)
        if m:
            name, cur = m.group(1), []
            continue
        if line.startswith("}"):
            if name is not None:
                comps[name] = cur
            name, cur = None, None
            continue
        if cur is not None:
            cur.append(line)
    return comps


def _call_graph(comps):
    """Edges computation -> referenced computations (while body/cond,
    fusion calls, to_apply)."""
    edges = {n: set() for n in comps}
    pat = re.compile(r"(?:body|condition|to_apply|calls)=%?([\w.\-]+)")
    for cname, lines in comps.items():
        for ln in lines:
            for ref in pat.findall(ln):
                if ref in comps:
                    edges[cname].add(ref)
    return edges


def _reachable(edges, start):
    seen, stack = set(), [start]
    while stack:
        c = stack.pop()
        if c in seen:
            continue
        seen.add(c)
        stack.extend(edges.get(c, ()))
    return seen


def runtime_collectives(hlo: str, m: int):
    """Per-ITERATION runtime collective count/bytes, loop-aware.

    A textual count over-/under-counts once XLA keeps ``lax.scan`` as a
    while loop: the Lanczos scan body appears ONCE in text but executes
    m-1 times (round-4's 31-all-gather figure was a count of a program
    whose scan XLA had unrolled — correct then, wrong after any compile-
    decision change). Weighting is by CALL-GRAPH attribution: a
    collective inside a computation reachable from a while body/cond is
    weighted by the Lanczos trip count m-1; collectives in the entry or
    in called-once computations (fusions, conditional branches) count
    once. If collectives appear under MORE than one distinct while, or
    under nested whiles, trip-count attribution is ambiguous and this
    raises instead of publishing a silently wrong budget."""
    comps = _parse_computations(hlo)
    entry = next((n for n in comps if n.startswith("main")), None)
    assert entry is not None, "no main computation found in HLO"
    edges = _call_graph(comps)

    # while instructions anywhere in the module, each with the set of
    # computations reachable from its body+condition
    bpat = re.compile(r"body=%?([\w.\-]+)")
    cpat = re.compile(r"condition=%?([\w.\-]+)")
    whiles = []  # [(label, reachable-scope set)]
    for cname, lines in comps.items():
        for ln in lines:
            if " while(" not in ln and not ln.lstrip().startswith("while("):
                continue
            parts = [x for p in (bpat, cpat) for x in p.findall(ln)
                     if x in comps]
            if parts:
                scope = set().union(*(_reachable(edges, x) for x in parts))
                whiles.append((parts[0], scope))

    pat = re.compile(
        r"= (\([^)]*\)|\w+\[[0-9,]*\][^ ]*) (all-reduce|all-gather|"
        r"reduce-scatter|collective-permute|all-to-all)\(")
    out = {}

    def add(op, bts, mult):
        ent = out.setdefault(op, {"count": 0, "bytes": 0})
        ent["count"] += mult
        ent["bytes"] += bts * mult

    loops_with_collectives = set()
    for cname, lines in comps.items():
        covering = [lbl for lbl, scope in whiles if cname in scope]
        for ln in lines:
            mm = pat.search(ln)
            if not mm:
                continue
            if len(set(covering)) > 1:
                # nested whiles or multiple loops covering this comp:
                # the true trip count is a product we cannot know from
                # HLO text — refuse to publish a guessed budget
                raise RuntimeError(
                    f"collective in {cname} is reachable from whiles "
                    f"{sorted(set(covering))} — ambiguous trip-count "
                    "attribution")
            loops_with_collectives.update(covering)
            if len(loops_with_collectives) > 1:
                # only ONE loop (the Lanczos scan, trip count m-1) may
                # carry collectives; a second would need its own count
                raise RuntimeError(
                    "multiple collective-bearing loops: "
                    f"{sorted(loops_with_collectives)}")
            mult = (m - 1) if covering else 1
            shape = mm.group(1)
            if shape.startswith("("):
                b = sum(_shape_bytes(p) for p in
                        re.findall(r"\w+\[[0-9,]*\][^ ,)]*", shape))
            else:
                b = _shape_bytes(shape)
            add(mm.group(2), b, mult)
    return out


def _shape_bytes(sh):
    dt_bytes = {"f32": 4, "bf16": 2, "f64": 8, "s32": 4, "u32": 4,
                "pred": 1, "f16": 2, "s64": 8}
    m = re.match(r"(\w+?)\[([0-9,]*)\]", sh)
    if m is None:
        return 0
    elems = 1
    for d in m.group(2).split(","):
        if d:
            elems *= int(d)
    return elems * dt_bytes.get(m.group(1), 4)


def gram_path(n_pad=20480, m=10):
    """Row-sharded-K Gram step lowered AT THE BENCH SHAPE (n_pad=20480,
    the rcv1/news20 row count): collectives per full Krylov-CRN
    iteration ((m+2) K-matvecs; GSPMD all-gathers each matvec's
    n/D-local output).

    Round-5 change: the step pins every matvec output row-sharded ->
    replicated (gram_krylov_step's ``repl``), so the Lanczos and
    line-search reductions lower collective-free on replicated operands
    instead of emitting an extra fold all-gather per compensated dot
    (round-4: 31 AG + 7 AR per iteration). The remaining collectives are
    the structural
    (m+2) n-vector all-gathers of the sequential matvec chain.

    Counting is loop-aware (see runtime_collectives): the round-4
    numbers counted an unrolled-scan text; with the scan kept as a
    while loop a textual count would read 3."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from krylov_crn_tpu.ops.gram import GramData
    from krylov_crn_tpu.parallel.mesh import DATA_AXIS
    from krylov_crn_tpu.solvers.krylov_crn import _accum_dtype
    from krylov_crn_tpu.solvers.krylov_gram import (
        GramKrylovState,
        gram_krylov_step,
    )

    mesh = Mesh(np.array(jax.devices()[:8]), (DATA_AXIS,))
    row = NamedSharding(mesh, P(DATA_AXIS, None))
    repl = NamedSharding(mesh, P())
    f32 = jnp.float32

    def S(shape, dtype=f32, sh=repl):
        return jax.ShapeDtypeStruct(shape, dtype, sharding=sh)

    n = n_pad - 238  # mimic rcv1-like padding (20242 -> 20480)
    gd = GramData(
        K=S((n_pad, n_pad), sh=row), Ax0=S((n_pad,)), b=S((n_pad,)),
        mask=S((n_pad,)), x0_sqnorm=S(()),
        K_lr=None,  # bf16_head is off by default since round 4
        n=n, d=47236, nnz=1498952)
    vec = S((n_pad,))
    st0 = GramKrylovState(
        gamma=S(()), zeta=vec, Ax=vec, Ax_lo=vec, w_g=vec, uK=vec,
        value=S(()), value_lo=S(()), reg_coef=S(()), r0=S(()),
        solver_it=S((), jnp.int32), diff_norm=S(()), grad_norm=S(()),
        f_best=S(()), f_best_lo=S(()))
    kw = dict(m=m, l2=0.0, beta=0.5, solver_eps=1e-8, solver_it_max=100,
              ls_max=20, reorth_passes=1,
              accum_dtype=_accum_dtype(f32), rederive=False,
              use_lr=False, repl=repl)
    lowered = gram_krylov_step.lower(gd, st0, **kw)
    hlo = lowered.compile().as_text()
    stc = runtime_collectives(hlo, m)
    # sanity vs the design: no bulk gathers beyond one n-vector per
    # matvec (an f32[n_pad, n_pad] all-gather would mean GSPMD chose to
    # replicate K — the failure mode the two-stage pin exists to block)
    assert all(e["bytes"] <= (m + 4) * n_pad * 4 * 8
               for e in stc.values()), stc
    return {
        "program": f"gram_krylov_step (row-sharded K, n_pad={n_pad}, "
                   f"m={m}, bench shape, repl-pinned, loop-aware count)",
        "collectives": stc,
        "local_K_bytes_per_device_per_matvec": n_pad * n_pad * 4 // 8,
        "matvecs_per_iteration": m + 2,
    }


def main():
    out = {
        "coo": coo_path(),
        "gram": gram_path(),
    }
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
