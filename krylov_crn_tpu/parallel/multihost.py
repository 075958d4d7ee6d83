"""Multi-host execution: distributed init + per-host data loading.

The reference is a single process end to end (SURVEY.md §2.2) — this layer
is net-new here. Responsibilities:

* ``init_distributed`` — ``jax.distributed.initialize`` wiring (NVLink
  within a host, the network across hosts; XLA hands the transport to
  NCCL once processes rendezvous at the coordinator);
* ``split_bytes_by_rows`` / ``load_libsvm_rows`` — each host reads and
  parses ONLY its byte range of the LIBSVM text file (byte count is a
  faithful nnz proxy, so contiguous byte-balanced splits are nnz-balanced
  without a global indptr pass). The reference downloads + parses the
  whole file on one host (cubic_newton.py:50-52);
* ``load_sharded_libsvm`` — the per-host pipeline: parse local rows,
  agree on global (d, sizes) across processes, build the local COO shards,
  and assemble global jax Arrays with
  ``jax.make_array_from_process_local_data`` over the row-sharded mesh.

Single-process runs (including the 8-virtual-CPU-device test mesh) follow
the identical code path; the cross-process agreement reductions reduce to
identities when ``jax.process_count() == 1``.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "init_distributed",
    "split_bytes_by_rows",
    "load_libsvm_rows",
    "load_sharded_libsvm",
]


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> int:
    """Initialize multi-host JAX. Returns the process id.

    A multi-process run passes all three arguments (coordinator as
    ``host:port``): nothing on a GPU host tells JAX of a cluster by
    itself. A no-op when JAX is already initialized or when running
    single-process.
    """
    import jax

    if jax.process_count() > 1:
        return jax.process_index()  # already initialized by the runtime
    if coordinator_address is None and num_processes in (None, 1):
        return 0  # single-process run: nothing to initialize
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return jax.process_index()


def _allgather_host(x: np.ndarray) -> np.ndarray:
    """Gather a small host array from every process (identity when
    single-process)."""
    import jax

    if jax.process_count() == 1:
        return x[None]
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(x))


def global_label_coding(labels: np.ndarray,
                        allgather=None) -> np.ndarray:
    """Labels -> {0,1} with a value->bit coding agreed ACROSS processes.

    canonicalize_labels' "any other pair -> first-seen label" rule
    (data/libsvm.py; reference loss.py:190-207 semantics) is order-
    dependent: two hosts whose byte ranges start with different classes
    would encode labels oppositely — silent class inversion. This
    gathers the distinct label values plus the globally-first label
    (process 0's first row) and applies one shared coding: {0,1}/{1,2}/
    {-1,1} by the standard maps, any other pair -> 1 for the global
    first-seen label. ``allgather`` is injectable for testing."""
    if allgather is None:
        allgather = _allgather_host
    labels = np.asarray(labels)
    lu = np.unique(labels) if labels.size else np.empty(0)
    pad = np.full(3, np.nan)
    pad[: min(len(lu), 3)] = lu[:3]
    first = float(labels[0]) if labels.size else np.nan
    gath = np.atleast_2d(allgather(np.array([*pad, first], np.float64)))
    vals_seen = gath[:, :3].ravel()
    gl = np.unique(vals_seen[~np.isnan(vals_seen)])
    if len(gl) > 2:
        raise ValueError(
            "The number of classes must be no more than 2 for binary "
            f"classification (saw values {gl[:4]}...)")
    firsts = gath[:, 3]
    firsts = firsts[~np.isnan(firsts)]
    first_global = float(firsts[0]) if firsts.size else 0.0
    if np.array_equal(gl, [0, 1]):
        return labels.astype(np.float64)
    if np.array_equal(gl, [1, 2]):
        return (labels - 1).astype(np.float64)
    if np.array_equal(gl, [-1, 1]):
        return ((labels + 1) / 2).astype(np.float64)
    return (labels == first_global).astype(np.float64)


def split_bytes_by_rows(path: str, num_parts: int,
                        part: int) -> tuple[int, int]:
    """Contiguous byte range [start, end) of `part`, snapped to line
    boundaries. Byte-balanced splits of LIBSVM text are nnz-balanced to
    first order (bytes-per-line scales with tokens-per-line)."""
    import os

    size = os.path.getsize(path)
    targets = [size * i // num_parts for i in range(num_parts + 1)]

    def snap(off):
        if off in (0, size):
            return off
        with open(path, "rb") as fh:
            fh.seek(off)
            # advance to the next newline so rows are never split
            chunk = fh.read(1 << 20)
            j = chunk.find(b"\n")
            return off + j + 1 if j >= 0 else size

    start = snap(targets[part])
    end = snap(targets[part + 1])
    return start, min(max(end, start), size)


def load_libsvm_rows(path: str, byte_range: tuple[int, int],
                     backend: str = "auto"):
    """Parse only [start, end) of the file -> (labels, rows, cols, vals)
    with *local* row ids and raw (possibly 1-based) column ids."""
    from krylov_crn_tpu.data.libsvm import _parse_native, _parse_python

    start, end = byte_range
    with open(path, "rb") as fh:
        fh.seek(start)
        data = fh.read(end - start)
    if backend == "auto":
        try:
            return _parse_native(data)
        except Exception:
            return _parse_python(data)
    if backend == "native":
        return _parse_native(data)
    return _parse_python(data)


def load_sharded_libsvm(path: str, mesh, dtype=np.float32,
                        zero_based: str | bool = "auto",
                        pad_to: int = 1024, backend: str = "auto"):
    """Per-host LIBSVM -> row-sharded ``ShardedDual`` + padded labels.

    Every process parses its own byte range (never the global file),
    sub-partitions its rows nnz-balanced over its local devices, and the
    global arrays are assembled from process-local shards. Returns
    ``(ShardedDual, b_padded)`` where ``b_padded`` is the row-sharded
    {0,1} label vector in the (D * n_l,) padded layout.
    """
    import jax
    import scipy.sparse as sp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from krylov_crn_tpu.parallel.mesh import DATA_AXIS
    from krylov_crn_tpu.parallel.sharded import ShardedDual, partition_rows

    nproc = jax.process_count()
    pid = jax.process_index()
    local_devices = mesh.local_devices
    n_local_dev = len(local_devices)
    D = mesh.devices.size

    byte_range = split_bytes_by_rows(path, nproc, pid)
    labels, rows, cols, vals = load_libsvm_rows(path, byte_range,
                                                backend=backend)

    # ---- global agreement: column count, 0/1-basing, label coding ----
    local_meta = np.array([
        int(cols.max()) + 1 if cols.size else 0,  # d upper bound (raw ids)
        int(cols.min()) if cols.size else 1,      # min col id seen
        labels.shape[0],                          # local row count
        rows.shape[0],                            # local nnz
    ], np.int64)
    metas = _allgather_host(local_meta)
    d_raw = int(metas[:, 0].max())
    if zero_based == "auto":
        zero_based = int(metas[:, 1].min()) == 0
    if not zero_based:
        cols = cols - 1
        d_raw -= 1
    d = int(d_raw)
    n_total = int(metas[:, 2].sum())

    b01 = global_label_coding(labels)

    # ---- local CSR, nnz-balanced over this host's devices ----
    n_loc = labels.shape[0]
    A_loc = sp.csr_matrix(
        (vals, (rows, cols)), shape=(n_loc, d), dtype=np.float64)
    ranges = partition_rows(A_loc.indptr, n_local_dev)

    # global uniform shard sizes: max over ALL processes' shards
    def _round_up(x, m):
        return ((x + m - 1) // m) * m

    loc_rows_max = max(max(e - s for s, e in ranges), 1)
    loc_nnz_max = max(
        max(int(A_loc.indptr[e] - A_loc.indptr[s]) for s, e in ranges), 1)
    sizes = _allgather_host(np.array([loc_rows_max, loc_nnz_max], np.int64))
    n_l = _round_up(int(sizes[:, 0].max()), 8)
    nnz_l = _round_up(int(sizes[:, 1].max()), pad_to)

    a_rows, a_cols, a_vals = [], [], []
    t_list, masks, b_list = [], [], []
    nnzt_raw = 0
    for s, e in ranges:
        blk = A_loc[s:e].tocoo()
        order = np.argsort(blk.row, kind="stable")
        r = blk.row[order].astype(np.int32)
        c = blk.col[order].astype(np.int32)
        v = blk.data[order].astype(dtype)
        k = nnz_l - len(r)
        a_rows.append(np.concatenate(
            [r, np.full(k, max(e - s - 1, 0), np.int32)]))
        a_cols.append(np.concatenate([c, np.zeros(k, np.int32)]))
        a_vals.append(np.concatenate([v, np.zeros(k, dtype)]))
        # transpose shard: rows = global col ids, cols = local row ids
        ordt = np.argsort(c, kind="stable")
        t_list.append((c[ordt], r[ordt], v[ordt]))
        nnzt_raw = max(nnzt_raw, len(c))
        m = np.zeros(n_l, dtype)
        m[: e - s] = 1
        masks.append(m)
        bb = np.zeros(n_l, dtype)
        bb[: e - s] = b01[s:e]
        b_list.append(bb)
    sizes_t = _allgather_host(np.array([nnzt_raw], np.int64))
    nnzt_l = _round_up(max(int(sizes_t.max()), 1), pad_to)
    at_rows, at_cols, at_vals = [], [], []
    for tr, tc, tv in t_list:
        k = nnzt_l - len(tr)
        at_rows.append(np.concatenate([tr, np.full(k, d - 1, np.int32)]))
        at_cols.append(np.concatenate([tc, np.zeros(k, np.int32)]))
        at_vals.append(np.concatenate([tv, np.zeros(k, dtype)]))

    row_shard = NamedSharding(mesh, P(DATA_AXIS))

    def put(stack):
        local = np.concatenate(stack)
        return jax.make_array_from_process_local_data(row_shard, local)

    nnz_tot = int(metas[:, 3].sum())
    sd = ShardedDual(
        a_vals=put(a_vals), a_rows=put(a_rows), a_cols=put(a_cols),
        at_vals=put(at_vals), at_rows=put(at_rows), at_cols=put(at_cols),
        mask=put(masks),
        n=n_total, d=d, nnz=nnz_tot, n_local=n_l, n_shards=D, mesh=mesh,
    )
    return sd, put(b_list)
