"""Gram-space (row-kernel) formulation — the dense compute path.

Sparse nnz-wise kernels are gather/scatter-bound on an accelerator; the
fast engines are matrix units and dense streaming of device memory. This
module therefore reformulates the entire second-order solver to run on
*dense n x n* linear algebra:

For logistic regression the loss, gradients, Hessians and every Krylov
vector generated from them live in the affine subspace

    x  =  gamma * x0  +  A^T zeta ,        zeta in R^n

(gradients are A^T(residual)/n + l2*x — see loss.py:223-232 — and H maps
the subspace to itself). Tracking the *representation* (gamma, zeta)
instead of x closes every operation over the n x n Gram matrix

    K = A A^T          (dense on device; text-corpus K is ~100% dense)

with these identities (b-margins Ax = gamma*Ax0 + K zeta):

    A v            = beta * Ax0 + K w                for v = beta*x0 + A^T w
    H v            = (l2*beta,  D(Av)/n + l2 w)      one K-matvec per HVP
    <v, v'>        = bb' |x0|^2 + b(Ax0.w') + b'(Ax0.w) + w.u' - b'(w.Ax0)
                     where u = A v is carried alongside (u' = Av') — zero
                     extra matvecs for any inner product
    ||x||^2        = g^2|x0|^2 + 2g Ax0.zeta + zeta.(Ax - g Ax0)

d (the feature dimension) appears only at build time (K, Ax0) and when an
explicit iterate is materialized (one transpose SpMV per checkpoint).
Per Krylov-CRN iteration: m+1 dense K-matvecs (m Lanczos hops and the
gradient image; m+2 with margin re-derivation) ~= (m+1) * n^2 * 4B of
device-memory traffic (half that through the triangle kernel,
ops/symv.py). Applicable when n fits a dense K (n ~ 45k is 8 GB at fp32);
complements the dense-A path (small d) and the COO path (fallback).
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import os
from pathlib import Path
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["GramData", "build_gram", "Rep", "rep_dot", "gram_lanczos"]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad_rows(n: int) -> int:
    """Row padding of the dense K. On the GPU, fp32 Gram matvecs run the
    upper-triangle SYMV kernel (ops/symv.py), whose folded grid needs an
    even number of tiles: pad to 2 * TILE (the waste is under 2 * TILE
    rows, 2.4% of K's bytes at n ~ 20k). CPU/verification builds keep
    the tight 256 alignment."""
    from krylov_crn_tpu.ops.symv import TILE

    gran = 2 * TILE if jax.default_backend() == "gpu" else 256
    return _round_up(n, gran)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class GramData:
    """Dense Gram-space problem data (rows padded to n_pad).

    ``K_lr`` is an optional bf16 copy of K: Lanczos subspace construction
    tolerates a ~1e-3-perturbed (still symmetric PSD) operator, halving
    the HBM traffic of the m matvecs per iteration; margins and gradients
    always use the fp32 K so loss values stay exact.
    """

    K: jax.Array  # (n_pad, n_pad) Gram matrix A A^T
    Ax0: jax.Array  # (n_pad,) margins of the base point x0
    b: jax.Array  # (n_pad,) labels in {0,1}, 0 on padding
    mask: jax.Array  # (n_pad,) 1 on real rows
    x0_sqnorm: jax.Array  # scalar |x0|^2
    K_lr: jax.Array | None  # optional low-precision K for Lanczos
    n: int = dataclasses.field(metadata=dict(static=True))
    d: int = dataclasses.field(metadata=dict(static=True))
    nnz: int = dataclasses.field(metadata=dict(static=True))
    # static: fp32 K-matvecs route through the upper-triangle SYMV
    # kernel (ops/symv.py; single-device GPU only — K is exactly
    # symmetric by construction)
    symv: bool = dataclasses.field(default=False,
                                   metadata=dict(static=True))

    @property
    def n_padded(self) -> int:
        return self.K.shape[0]

    @property
    def K_lanczos(self):
        return self.K if self.K_lr is None else self.K_lr


def _cache_key(A, x0) -> str:
    h = hashlib.sha1()
    h.update(np.ascontiguousarray(A.indptr).tobytes())
    h.update(np.ascontiguousarray(A.indices[:4096]).tobytes())
    h.update(np.ascontiguousarray(A.data[:4096]).tobytes())
    h.update(np.asarray(x0).tobytes())
    h.update(str(A.shape).encode())
    return h.hexdigest()[:16]


# K accumulates in fp64 and is rounded once: fp32 products on GPU tensor
# cores accumulate with a bias (measured on the H100: a split-bf16
# build of K read -6.6e-7 relative mean error against an fp64 build,
# 30x the rounding of the exact K), which the solver turns into
# within-chunk rises of the exact loss (PERF.md). The panel GEMMs run in
# fp64 under a scoped x64 switch; the fp32 K the solver sees is the
# exact K rounded once.
KACC = jnp.float64


@functools.partial(jax.jit, donate_argnums=(0, 1))
def _scan_build_K(K, B, R, C, V, F):
    """The device program of _build_K_device: scan over uniform nnz
    chunks, scattering into the panel buffer B and GEMM-flushing into K
    at each end-of-panel flag. Module-level so jax.jit's cache (and the
    persistent compilation cache) key on shapes, not closure identity.

    The flush is *masked* (GEMM every chunk, accumulate/reset scaled by
    the flag) rather than a ``lax.cond``, whose variant of this body
    compiled 46x slower when it was measured; chunk sizing keeps the
    surplus GEMMs near zero (most panels are a single chunk)."""

    def body(carry, triple):
        K, B = carry
        r, c, v, f = triple
        B = B.at[r.astype(jnp.int32), c.astype(jnp.int32)].add(
            v.astype(B.dtype))
        fK = f.astype(K.dtype)
        K = _panel_accum(K, B, scale=fK)
        B = B * (1.0 - fK)
        return (K, B), ()

    (K, B), _ = jax.lax.scan(body, (K, B), (R, C, V, F))
    return K, B


def _panel_accum(K, B, scale=None):
    """K += [scale *] B @ B^T in K's (fp64 accumulation) dtype."""
    G = jax.lax.dot_general(B, B, (((1,), (1,)), ((), ())),
                            precision=jax.lax.Precision.HIGHEST)
    return K + (G if scale is None else scale * G)


@functools.partial(jax.jit, static_argnames=("dtype",))
def _round_K(K, dtype):
    """The accumulated K, symmetrized and rounded to the storage dtype.
    0.5 * (K + K^T) is bitwise symmetric (fp add commutes), so the
    rounded K is too: the SYMV kernel (ops/symv.py) reads only the upper
    triangle."""
    return (0.5 * (K + K.T)).astype(dtype)


def _panels_scan(K, Rf, CE, Vf, starts, lens, pidx, cb, cap):
    """Panel scan over the EXACT flat nnz stream with device-side
    padding: each panel dynamic-slices a ``cap``-sized window at its
    start offset, masks the tail beyond its length, scatters into the
    (n_pad x cb) buffer B and GEMM-accumulates into K.

    Only the exact nnz stream (+ the last window's tail padding) crosses
    the host link — no per-panel padding is shipped; the masking costs
    ~cap elementwise ops per panel on device. GEMM count equals panel
    count.

    ``CE``: per-active-column END offsets into the flat stream, padded
    to nblk*cb with nnz — the within-panel column position of each nnz
    is RECONSTRUCTED on device instead of shipped (a column stream would
    cost 2 B per nnz): inside a window starting at s, entry p
    belongs to local column #{ends <= p}, computed as one scatter of
    the panel's cb ends + an inclusive cumsum over the window. Column
    ends of a panel's own columns are > s (every compacted column is
    non-empty), the trailing pad ends land at >= ln where ``valid``
    masks them out, so the reconstruction is exact."""
    npad = K.shape[0]
    iota = jax.lax.iota(jnp.int32, cap)

    def panel(K, sl):
        s, ln, i = sl
        r = jax.lax.dynamic_slice(Rf, (s,), (cap,)).astype(jnp.int32)
        v = jax.lax.dynamic_slice(Vf, (s,), (cap,)).astype(K.dtype)
        ce = jax.lax.dynamic_slice(CE, (i * cb,), (cb,))
        ind = jnp.zeros(cap + 1, jnp.int32)
        ind = ind.at[jnp.clip(ce - s, 0, cap)].add(1)
        c = jnp.cumsum(ind[:cap])  # inclusive: #ends <= p
        valid = iota < ln
        B = jnp.zeros((npad, cb), K.dtype)
        B = B.at[jnp.where(valid, r, 0), jnp.where(valid, c, 0)].add(
            jnp.where(valid, v, jnp.zeros((), K.dtype)))
        return _panel_accum(K, B), ()

    K, _ = jax.lax.scan(panel, K, (starts, lens, pidx))
    return K


@functools.partial(jax.jit, static_argnames=("cb", "cap", "npad"))
def _scan_build_K_seg0(Rf, CE, Vf, starts, lens, pidx, cb, cap, npad):
    """First build segment: creates K = 0 in-program (an eager
    jnp.zeros((npad, npad)) would be one more program to load) and
    scans its panels."""
    K = jnp.zeros((npad, npad), KACC)
    return _panels_scan(K, Rf, CE, Vf, starts, lens, pidx, cb, cap)


@functools.partial(jax.jit, donate_argnums=(0,),
                   static_argnames=("cb", "cap"))
def _scan_build_K_seg(K, Rf, CE, Vf, starts, lens, pidx, cb, cap):
    """Continuation segment of the panel scan. Device work per dispatch
    is bounded by the segment length; whether one program for the
    whole build is better on the GPU awaits a measurement (ROADMAP)."""
    return _panels_scan(K, Rf, CE, Vf, starts, lens, pidx, cb, cap)


def _finalize_state_flat(K, aux, ibuf, vdt, lr):
    """The build's tail: bf16 Lanczos copy, aux unpack, and the initial
    solver-state arrays (see solvers/krylov_gram._init_state_packed for
    the semantics — the same construction in one program)."""
    cdt = K.dtype
    npad = K.shape[0]
    K_lr = K.astype(jnp.bfloat16) if lr else None
    Ax0, bb, mask = aux[0], aux[1], aux[2]
    x0sq = aux[3, 0]
    Ax_lo = ibuf[:npad]
    w0 = ibuf[npad:2 * npad]
    uK0 = ibuf[2 * npad:3 * npad]
    s = ibuf[3 * npad:3 * npad + 3]
    if jnp.dtype(vdt) == cdt:
        value, value_lo = s[0], s[1]
    else:
        value = s[0].astype(vdt) + s[1].astype(vdt)
        value_lo = jnp.zeros((), vdt)
    zero = jnp.zeros((), cdt)
    state_flat = (jnp.ones((), cdt), jnp.zeros(npad, cdt), Ax0, Ax_lo,
                  w0, uK0, value, value_lo, s[2],
                  jnp.asarray(0.1, cdt), jnp.zeros((), jnp.int32),
                  zero + jnp.inf, zero + jnp.inf, value, value_lo)
    return K, K_lr, Ax0, bb, mask, x0sq, state_flat


def _pack_flat_panels(A, n_pad, dtype, col_block=2048):
    """Host-side packing for the device-padded panel scan: compact empty
    columns, cut into ``col_block``-wide panels, and emit the EXACT flat
    (rows, vals) streams + per-active-column end offsets CE (the
    within-panel column positions are reconstructed on device from CE —
    see _panels_scan) plus per-panel (start, len).

    Returns None under heavy column skew (one panel holding most of the
    nnz would make every panel's cap-sized window re-stream ~nnz
    elements — quadratic device work); callers fall back to the
    masked-GEMM chunk stream."""
    Acsc = A.tocsc()
    counts = np.diff(Acsc.indptr)
    active = np.flatnonzero(counts)
    if len(active) < Acsc.shape[1]:
        Acsc = Acsc[:, active]
    d = int(Acsc.shape[1])
    cb = min(_round_up(max(d, 1), 512), col_block)
    nblk = -(-d // cb)
    starts = Acsc.indptr[np.arange(nblk) * cb].astype(np.int32)
    ends = Acsc.indptr[np.minimum(np.arange(1, nblk + 1) * cb, d)]
    lens = (ends - starts).astype(np.int32)
    cap = _round_up(int(lens.max()) if nblk else 1, 8192)
    if nblk * cap > 4 * max(1, int(Acsc.nnz)):
        return None  # heavy skew: masked fallback
    ridt = np.uint16 if n_pad <= 65535 else np.int32
    nnz = int(Acsc.nnz)
    # stream length: every cap-sized window must fit, i.e. up to
    # starts[-1] + cap — NOT nnz + cap (a full extra cap of zeros was
    # ~25% of the rcv1-like stream)
    L = int(starts[-1]) + cap if nblk else cap
    Rf = np.zeros(L, ridt)
    Rf[:nnz] = Acsc.indices
    # per-active-column END offsets, padded to nblk*cb with nnz: the
    # within-panel column position of each nnz is reconstructed on
    # device from these (see _panels_scan) — 4 B per ACTIVE COLUMN
    # instead of 2 B per NNZ (news20-like: ~1 MB vs 18 MB)
    CE = np.full(nblk * cb, nnz, np.int32)
    CE[:d] = Acsc.indptr[1:d + 1]
    Vf = np.zeros(L, dtype)
    Vf[:nnz] = Acsc.data.astype(dtype)
    return Rf, CE, Vf, starts, lens, cb, cap, nblk


def _build_K_device(A, n_pad: int, dtype, col_block: int = 2048,
                    chunk_nnz: int | None = None):
    """K = A A^T computed on-device, accumulated in fp64 and returned
    symmetrized and rounded to ``dtype`` (see KACC).

    Column panels of width ``col_block`` are densified by scatter into a
    (n_pad x cb) buffer B and GEMM'd into K (K += B @ B^T); only
    ~6 B/nnz crosses the host link. Three constraints shape the design:

    * scatter *compile* time scales with the target array's cell count
      (a 1e9-cell scatter took minutes to compile), so the panel buffer
      is a fixed modest (n_pad x 2048) shape;
    * a per-panel dispatch loop pays a dispatch per panel — so the
      build is a ``lax.scan`` over panels, 64 panels per program,
      compiled once per dataset (and persisted via the compilation
      cache);
    * a scan needs uniform shapes. In the panel layout (_panels_scan)
      each panel slices a fixed-size window of the flat nnz stream and
      ONE GEMM flushes per panel; in the skew fallback (_scan_build_K)
      the stream is cut into fixed-size chunks and an end-of-panel flag
      gates a *masked* GEMM accumulate — NOT a ``lax.cond``, which
      compiled 46x slower (see _scan_build_K's docstring).
    """
    # K = A A^T is invariant to dropping all-zero columns; _pack_flat_
    # panels compacts them away so the panel count (and the GEMM work,
    # n_pad^2 * d_panels) scales with the *active* columns.
    packed = _pack_flat_panels(A, n_pad, dtype, col_block)
    if packed is not None:
        return _panel_build(packed, n_pad, dtype, 64, jnp.asarray)

    # ---- masked-GEMM fallback (exact-size chunk stream) ----
    Acsc = A.tocsc()
    counts = np.diff(Acsc.indptr)
    active = np.flatnonzero(counts)
    if len(active) < Acsc.shape[1]:
        Acsc = Acsc[:, active]
    d = int(Acsc.shape[1])
    cb = min(_round_up(max(d, 1), 512), col_block)
    nblk = -(-d // cb)
    panel_nnz = np.asarray(
        [int(Acsc.indptr[min((i + 1) * cb, d)] - Acsc.indptr[i * cb])
         for i in range(nblk)], np.int64)
    max_panel = int(panel_nnz.max()) if nblk else 1
    if chunk_nnz is None:
        chunk_nnz = 8192
        while chunk_nnz * 4 < max_panel and chunk_nnz < 262144:
            chunk_nnz *= 2
    ridt = np.uint16 if n_pad <= 65535 else np.int32
    R_parts, C_parts, V_parts, flags = [], [], [], []
    for i in range(nblk):
        c0, c1 = i * cb, min((i + 1) * cb, d)
        s, e = int(Acsc.indptr[c0]), int(Acsc.indptr[c1])
        rows = Acsc.indices[s:e].astype(ridt)
        vals = Acsc.data[s:e].astype(dtype)
        counts = np.diff(Acsc.indptr[c0:c1 + 1])
        colpos = np.repeat(np.arange(c1 - c0, dtype=np.int16), counts)
        nnzp = len(rows)
        nch = max(1, -(-nnzp // chunk_nnz))
        pad = nch * chunk_nnz - nnzp
        # padding entries carry zero values into row 0 / local col 0
        R_parts.append(np.concatenate([rows, np.zeros(pad, ridt)]))
        C_parts.append(np.concatenate([colpos, np.zeros(pad, np.int16)]))
        V_parts.append(np.concatenate([vals, np.zeros(pad, dtype)]))
        f = np.zeros(nch, bool)
        f[-1] = True  # last chunk of the panel flushes B into K
        flags.append(f)

    R = np.concatenate(R_parts).reshape(-1, chunk_nnz)
    C = np.concatenate(C_parts).reshape(-1, chunk_nnz)
    V = np.concatenate(V_parts).reshape(-1, chunk_nnz)
    F = np.concatenate(flags)

    seg = 256
    nchunks = R.shape[0]
    pad_ch = (-nchunks) % seg if nchunks > seg else 0
    if pad_ch:
        R = np.concatenate([R, np.zeros((pad_ch, chunk_nnz), ridt)])
        C = np.concatenate([C, np.zeros((pad_ch, chunk_nnz), np.int16)])
        V = np.concatenate([V, np.zeros((pad_ch, chunk_nnz), dtype)])
        F = np.concatenate([F, np.zeros(pad_ch, bool)])
        nchunks += pad_ch

    with jax.enable_x64(True):
        K = jnp.zeros((n_pad, n_pad), KACC)
        B = jnp.zeros((n_pad, cb), KACC)
        for s in range(0, nchunks, seg):
            e = min(s + seg, nchunks)
            K, B = _scan_build_K(K, B, jnp.asarray(R[s:e]),
                                 jnp.asarray(C[s:e]), jnp.asarray(V[s:e]),
                                 jnp.asarray(F[s:e]))
        return _round_K(K, dtype=jnp.dtype(dtype))


def _panel_build(packed, n_pad, dtype, seg_p, dev):
    """The panel path's dispatch plan: segments of ``seg_p`` panels
    accumulate K in fp64, then one program symmetrizes and rounds it.
    ``dev`` makes the device arrays — jnp.asarray for a build, device
    zeros for warm_build_gram_fused, which so runs byte-identical jit
    cache entries (a warm-up that diverges structurally warms the WRONG
    entries and leaves program loads inside the timed region)."""
    Rf, CE, Vf, starts, lens, cb, cap, nblk = packed
    pidx = np.arange(nblk, dtype=np.int32)
    with jax.enable_x64(True):
        Rd, Cd, Vd = dev(Rf), dev(CE), dev(Vf)
        K = None
        for s in range(0, nblk, seg_p):
            st, ln, pi = (dev(a[s:s + seg_p]) for a in (starts, lens, pidx))
            if K is None:
                K = _scan_build_K_seg0(Rd, Cd, Vd, st, ln, pi, cb=cb,
                                       cap=cap, npad=n_pad)
            else:
                K = _scan_build_K_seg(K, Rd, Cd, Vd, st, ln, pi, cb=cb,
                                      cap=cap)
        return _round_K(K, dtype=jnp.dtype(dtype))


@functools.partial(jax.jit, donate_argnums=(0,),
                   static_argnames=("vdt", "lr"))
def _finalize_init(K, aux, ibuf, vdt, lr):
    """Finalize + initial-state program: the fused build's tail."""
    return _finalize_state_flat(K, aux, ibuf, vdt, lr)


def build_gram_fused(A, b, x0, ibuf, dtype, vdt,
                     low_res_lanczos: bool | None = None,
                     seg_p: int = 64):
    """Device Gram build (_panel_build, or the skew fallback) + one
    finalize program that also makes the initial solver state.

    ``ibuf`` is the packed initial-state buffer [Ax_lo; w_g; uK; value
    pair, reg] of length 3*n_pad+3 (see solvers/krylov_gram.init_state,
    which computes it from three exact host fp64 SpMVs). Returns
    (GramData, state_flat) with state_flat the 15-tuple of initial
    GramKrylovState fields in declaration order."""
    A = A.tocsr()
    n, d = map(int, A.shape)
    n_pad = pad_rows(n)
    x0 = np.asarray(x0, np.float64)
    if low_res_lanczos is None:
        low_res_lanczos = np.dtype(dtype) == np.float32
    from krylov_crn_tpu.config import enable_compilation_cache

    enable_compilation_cache()

    Ax0 = np.zeros(n_pad, dtype)
    Ax0[:n] = A @ x0
    bp = np.zeros(n_pad, dtype)
    bp[:n] = np.asarray(b, dtype)
    mask = np.zeros(n_pad, dtype)
    mask[:n] = 1
    x0row = np.zeros(n_pad, dtype)
    x0row[0] = np.dtype(dtype).type(x0 @ x0)
    aux = jnp.asarray(np.stack([Ax0, bp, mask, x0row]))
    ibuf_d = jnp.asarray(ibuf)

    packed = _pack_flat_panels(A, n_pad, np.dtype(dtype))
    if packed is not None:
        K = _panel_build(packed, n_pad, dtype, seg_p, jnp.asarray)
    else:
        K = _build_K_device(A, n_pad, np.dtype(dtype))
    K, K_lr, Ax0_d, b_d, mask_d, x0sq, state_flat = _finalize_init(
        K, aux, ibuf_d, vdt=jnp.dtype(vdt), lr=low_res_lanczos)
    from krylov_crn_tpu.ops.symv import symv_supported

    gd = GramData(
        K=K, Ax0=Ax0_d, b=b_d, mask=mask_d, x0_sqnorm=x0sq,
        K_lr=K_lr, n=n, d=d, nnz=int(A.nnz),
        symv=symv_supported(n_pad, dtype))
    return gd, state_flat


def warm_build_gram_fused(A, dtype, vdt, low_res_lanczos: bool = False,
                          seg_p: int = 64):
    """Execute-once warm-up of every device program a subsequent
    build_gram_fused(A, ...) will dispatch — the same role warm_fused
    plays for the race programs (solvers/krylov_gram.py): compilation
    and the per-process executable load are code-loading costs, not
    part of any build's cost.

    The warm dispatch runs the REAL executables (byte-identical static
    args: the pack shapes of this A) over device-created zero arrays —
    jnp.zeros materializes on device, so the warm-up ships no nnz bytes
    across the host link; the timed build then pays only its real data
    transfer + device execution. Returns True if the panel path was
    warmed (False = masked fallback, which has its own per-dataset
    programs and no cheap warm path)."""
    A = A.tocsr()
    n, _ = map(int, A.shape)
    n_pad = pad_rows(n)
    from krylov_crn_tpu.config import enable_compilation_cache

    enable_compilation_cache()
    packed = _pack_flat_panels(A, n_pad, np.dtype(dtype))
    if packed is None:
        return False
    aux = jnp.zeros((4, n_pad), np.dtype(dtype))
    ibuf = jnp.zeros(3 * n_pad + 3, np.dtype(dtype))
    K = _panel_build(packed, n_pad, dtype, seg_p,
                     dev=lambda a: jnp.zeros(a.shape, a.dtype))
    out = _finalize_init(K, aux, ibuf, vdt=jnp.dtype(vdt),
                         lr=low_res_lanczos)
    # fetch one scalar data-dependent on the build: the warm-up has
    # finished on the device when this returns
    float(out[0][0, 0])
    return True


@jax.jit
def _to_bf16(K):
    return K.astype(jnp.bfloat16)


@jax.jit
def _unpack3(aux):
    return aux[0], aux[1], aux[2]


@jax.jit
def _finalize_gram(K, aux):
    """One program for the post-build steps: bf16 Lanczos copy + aux
    unpack (one program to load and dispatch instead of two)."""
    return K.astype(jnp.bfloat16), aux[0], aux[1], aux[2]


def build_gram(A, b, x0, dtype=np.float32, cache_dir: str | None = None,
               low_res_lanczos: bool | None = None,
               device_build: bool | None = None,
               mesh=None) -> GramData:
    """Build GramData from a scipy CSR matrix.

    K = A A^T is iterate-independent. On accelerator backends it is built
    on-device (streamed column blocks + GEMM, see _build_K_device); on
    CPU it uses scipy's sparse matmul with an optional disk cache.

    ``mesh``: optional 1-D device mesh — K is laid out row-sharded over
    the "data" axis (everything else replicated); under jit GSPMD then
    executes each K-matvec as a local (n/D x n) matvec + all-gather, so
    per-device HBM traffic scales 1/D. This is the multi-chip scaling
    path for the Gram solver.
    """
    import scipy.sparse as sp

    A = A.tocsr()
    n, d = map(int, A.shape)
    n_pad = pad_rows(n)
    x0 = np.asarray(x0, np.float64)

    if device_build is None:
        device_build = jax.default_backend() != "cpu"

    Kd = None
    if device_build:
        # K-build programs take seconds to compile; persist them so
        # repeat runs on the same dataset shape skip the compile
        from krylov_crn_tpu.config import enable_compilation_cache

        enable_compilation_cache()
        Kd = _build_K_device(A, n_pad, np.dtype(dtype))
    else:
        K = None
        cache_file = None
        if cache_dir is not None:
            Path(cache_dir).mkdir(parents=True, exist_ok=True)
            cache_file = Path(cache_dir) / f"gram_{_cache_key(A, x0)}.npy"
            if cache_file.exists():
                K = np.load(cache_file, mmap_mode=None)
        if K is None:
            K = np.asarray((A @ A.T).todense(), dtype)
            if cache_file is not None:
                np.save(cache_file, K)
        Kp = np.zeros((n_pad, n_pad), dtype)
        Kp[:n, :n] = K

    Ax0 = np.zeros(n_pad, dtype)
    Ax0[:n] = A @ x0
    bp = np.zeros(n_pad, dtype)
    bp[:n] = np.asarray(b, dtype)
    mask = np.zeros(n_pad, dtype)
    mask[:n] = 1

    if Kd is None:
        Kd = jnp.asarray(Kp)
    if low_res_lanczos is None:
        # bf16 Lanczos only pays off when fp32 Lanczos would be the
        # bottleneck (fp64 verification runs keep everything exact)
        low_res_lanczos = np.dtype(dtype) == np.float32
    # ONE packed transfer for the three aux vectors and ONE jitted
    # finalize program (bf16 copy + unpack) instead of eager ops that
    # each compile and dispatch on their own
    aux = jnp.asarray(np.stack([Ax0, bp, mask]))
    if low_res_lanczos:
        K_lr, Ax0_d, b_d, mask_d = _finalize_gram(Kd, aux)
    else:
        K_lr = None
        Ax0_d, b_d, mask_d = _unpack3(aux)
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        from krylov_crn_tpu.parallel.mesh import DATA_AXIS

        row_shard = NamedSharding(mesh, P(DATA_AXIS, None))
        repl = NamedSharding(mesh, P())
        Kd = jax.device_put(Kd, row_shard)
        if K_lr is not None:
            K_lr = jax.device_put(K_lr, row_shard)
        Ax0_d = jax.device_put(Ax0_d, repl)
        b_d = jax.device_put(b_d, repl)
        mask_d = jax.device_put(mask_d, repl)

    from krylov_crn_tpu.ops.symv import symv_supported

    return GramData(
        K=Kd, Ax0=Ax0_d, b=b_d,
        mask=mask_d,
        x0_sqnorm=jnp.asarray(float(x0 @ x0), dtype),
        K_lr=K_lr,
        n=n, d=d, nnz=int(A.nnz),
        # the SYMV kernel is single-device only (a Pallas call under a
        # GSPMD-sharded K would break the row-sharded lowering)
        symv=mesh is None and symv_supported(n_pad, dtype),
    )


def k_matvec(gd: "GramData", Kmat, q):
    """K @ q through the fastest available path: when the GramData was
    built symv-capable (single-device GPU, fp32, n_pad a multiple of
    2 * symv.TILE), fp32 matvecs stream only the upper triangle via the
    SYMV kernel (ops/symv.py; timed against XLA's matvec in PERF.md);
    all other cases use XLA's matvec. Same fp32 accuracy class either
    way (summation order differs only)."""
    if gd.symv and Kmat.dtype == jnp.float32:
        from krylov_crn_tpu.ops.symv import symv

        return symv(Kmat, q)
    return Kmat @ q


class Rep(NamedTuple):
    """v = beta * x0 + A^T w, with the image u = A v carried along."""

    beta: jax.Array  # scalar
    w: jax.Array  # (n_pad,)
    u: jax.Array  # (n_pad,) == beta * Ax0 + K w (maintained by linearity)


def rep_dot(gd: GramData, a: Rep, bv: Rep, adt):
    """<a, b> in the d-space, closed over carried images (no matvec).

    <a,b> = ba*bb*|x0|^2 + ba Ax0.wb + bb Ax0.wa + wa.K wb, and
    wa.K wb = wa.(ub - bb Ax0), so the bb-terms cancel. Reductions use
    compensated (Dekker) dots when adt == storage dtype (fp32 runs).
    """
    from krylov_crn_tpu.ops.math import accum_dot

    Ax0 = gd.Ax0.astype(adt)
    wa, wb = a.w.astype(adt), bv.w.astype(adt)
    ba, bb = a.beta.astype(adt), bv.beta.astype(adt)
    return (ba * bb * gd.x0_sqnorm.astype(adt)
            + ba * accum_dot(Ax0, wb, adt)
            + accum_dot(wa, bv.u.astype(adt), adt))


def rep_scale(a: Rep, s) -> Rep:
    return Rep(a.beta * s, a.w * s, a.u * s)


def rep_sub(a: Rep, b: Rep) -> Rep:
    return Rep(a.beta - b.beta, a.w - b.w, a.u - b.u)


def rep_axpy(y: Rep, alpha, x: Rep) -> Rep:
    return Rep(y.beta + alpha * x.beta, y.w + alpha * x.w,
               y.u + alpha * x.u)


class GramLanczosResult(NamedTuple):
    alphas: jax.Array  # (m,)
    betas: jax.Array  # (m-1,)
    Vb: jax.Array  # (m,) x0-coefficients of the basis
    Vw: jax.Array  # (m, n_pad) zeta-components
    Vu: jax.Array  # (m, n_pad) images A v_j  (the AV matrix for free)
    k: jax.Array  # valid basis count


def gram_lanczos(gd: GramData, hop, g: Rep, m: int,
                 reorth_passes: int = 1, breakdown_tol: float = 1e-6,
                 accum_dtype=jnp.float32) -> GramLanczosResult:
    """Lanczos on rep-space vectors; mirrors ops/lanczos.py (same masking
    and breakdown semantics, reference cubic.py:77-111) with all inner
    products in closed Gram form. ``hop(v: Rep) -> Rep`` applies H with
    exactly one K-matvec."""
    cdt = g.w.dtype
    adt = jnp.dtype(accum_dtype)
    npad = g.w.shape[0]

    g_norm = jnp.sqrt(jnp.maximum(rep_dot(gd, g, g, adt), 0.0)).astype(cdt)
    # numerically-zero gradient (exact convergence): produce a zero basis
    # rather than 0/0 NaNs — downstream steps then tie and freeze the state
    v0 = rep_scale(g, 1.0 / jnp.where(g_norm > 0, g_norm, 1.0))

    Vb0 = jnp.zeros((m,), cdt).at[0].set(v0.beta)
    Vw0 = jnp.zeros((m, npad), cdt).at[0].set(v0.w)
    Vu0 = jnp.zeros((m, npad), cdt).at[0].set(v0.u)

    def stacked_dots(Vb, Vw, Vu, t: Rep):
        """c_j = <V_j, t> for all j (same cancellation as rep_dot)."""
        Ax0 = gd.Ax0.astype(adt)
        tw, tb = t.w.astype(adt), t.beta.astype(adt)
        Vw_, Vb_ = Vw.astype(adt), Vb.astype(adt)
        return (Vb_ * tb * gd.x0_sqnorm.astype(adt)
                + Vb_ * jnp.dot(Ax0, tw)
                + Vw_ @ t.u.astype(adt))

    def reorth(t: Rep, Vb, Vw, Vu) -> Rep:
        for _ in range(reorth_passes):
            c = stacked_dots(Vb, Vw, Vu, t).astype(cdt)
            t = Rep(t.beta - jnp.dot(c, Vb), t.w - c @ Vw, t.u - c @ Vu)
        return t

    def body(carry, j):
        Vb, Vw, Vu, v_prev, v, beta_prev, active, k = carry
        Hv = hop(v)
        t = rep_axpy(Hv, -beta_prev, v_prev)
        alpha = rep_dot(gd, v, t, adt).astype(cdt)
        alpha_j = jnp.where(active, alpha, jnp.zeros((), cdt))
        t = rep_axpy(t, -alpha, v)
        if reorth_passes > 0:
            t = reorth(t, Vb, Vw, Vu)
        beta = jnp.sqrt(jnp.maximum(rep_dot(gd, t, t, adt), 0.0)).astype(cdt)
        ok = jnp.abs(beta) >= jnp.asarray(breakdown_tol, cdt)
        proceed = jnp.logical_and(active, ok)
        beta_j = jnp.where(proceed, beta, jnp.zeros((), cdt))
        inv = 1.0 / jnp.where(ok, beta, 1.0)
        v_next = Rep(
            jnp.where(proceed, t.beta * inv, v.beta),
            jnp.where(proceed, t.w * inv, v.w),
            jnp.where(proceed, t.u * inv, v.u),
        )
        v_prev_n = Rep(
            jnp.where(proceed, v.beta, v_prev.beta),
            jnp.where(proceed, v.w, v_prev.w),
            jnp.where(proceed, v.u, v_prev.u),
        )
        Vb = jnp.where(proceed, Vb.at[j + 1].set(v_next.beta), Vb)
        Vw = jnp.where(proceed, Vw.at[j + 1].set(v_next.w), Vw)
        Vu = jnp.where(proceed, Vu.at[j + 1].set(v_next.u), Vu)
        k = jnp.where(proceed, j + 2, k)
        return ((Vb, Vw, Vu, v_prev_n, v_next, beta_j, proceed, k),
                (alpha_j, beta_j))

    zero = Rep(jnp.zeros((), cdt), jnp.zeros(npad, cdt), jnp.zeros(npad, cdt))
    init = (Vb0, Vw0, Vu0, zero, v0, jnp.zeros((), cdt), jnp.asarray(True),
            jnp.asarray(1, jnp.int32))
    (Vb, Vw, Vu, _, v_last, _, _, k), (alphas, betas) = jax.lax.scan(
        body, init, jnp.arange(m - 1, dtype=jnp.int32))

    Hv = hop(v_last)
    alpha_last = rep_dot(gd, v_last, Hv, adt).astype(cdt)
    alphas = jnp.concatenate([alphas, jnp.zeros((1,), cdt)])
    alphas = alphas.at[k - 1].set(alpha_last)

    return GramLanczosResult(alphas=alphas, betas=betas, Vb=Vb, Vw=Vw,
                             Vu=Vu, k=k)
