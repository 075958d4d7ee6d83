"""bench.race scoring: min-of-attempts protocol invariants.

The driver-protocol scorer (bench.py race()) runs two end-to-end
attempts per side and scores mins — with non-obvious branches when
attempts disagree on crossing. These tests stub the attempt runners
(no accelerator needed) and pin:

  * ours: min over crossing attempts; build_s/final_gap come from the
    SAME best attempt as ours_s;
  * reference: only attempts that actually crossed are scored; if NONE
    crossed, the reported figure is the MAX of the attempts' wall
    times (each is a lower bound on its time-to-gap) and
    ref_gap_reached is False;
  * mixed reference attempts (one crossed, one not) score the crossed
    one, never the non-crossing lower bound.
"""

import numpy as np
import pytest

import bench


@pytest.fixture
def stub(monkeypatch):
    """Patch the heavy pieces; returns setters for attempt sequences."""
    monkeypatch.setattr(bench, "_problem",
                        lambda name: (None, None, None))
    monkeypatch.setattr("krylov_crn_tpu.data.synthetic.synthetic_meta",
                        lambda name: {"dataset": name})
    state = {}

    def set_ours(attempts):
        it = iter(attempts)
        monkeypatch.setattr(bench, "bench_ours",
                            lambda A, b, x0: next(it))

    def set_ref(attempts):
        it = iter(attempts)
        monkeypatch.setattr(bench, "bench_reference",
                            lambda A, b, x0: next(it))

    state["ours"], state["ref"] = set_ours, set_ref
    return state


def _ours_attempt(build_s, ts, fs, f_best):
    its = list(range(1, len(ts) + 1))
    return (build_s, its, ts, fs, f_best)


def test_min_over_crossing_attempts_and_consistent_best(stub):
    # attempt 1: slow (stall), crosses at t=2.0; attempt 2: crosses at 0.5
    stub["ours"]([
        _ours_attempt(1.0, [2.0], [1e-9], 1e-10),
        _ours_attempt(0.4, [0.5], [1e-9], 1e-10),
    ])
    stub["ref"]([
        ([1.0, 3.0], [1e-4, 1e-9], 1e-10),
        ([1.0, 3.5], [1e-4, 1e-9], 1e-10),
    ])
    out = bench.race("x")
    assert out["ours_s"] == pytest.approx(0.9)  # 0.4 + 0.5
    assert out["ours_attempts_s"] == [pytest.approx(3.0),
                                      pytest.approx(0.9)]
    assert out["build_s"] == pytest.approx(0.4)  # same attempt as ours_s
    assert out["ref_s"] == pytest.approx(3.0)
    assert out["ref_gap_reached"] is True
    assert out["speedup"] == pytest.approx(3.0 / 0.9, abs=0.01)


def test_reference_never_crossing_reports_max_lower_bound(stub):
    stub["ours"]([
        _ours_attempt(0.5, [1.0], [1e-9], 1e-10),
        _ours_attempt(0.5, [1.0], [1e-9], 1e-10),
    ])
    # neither reference attempt reaches the gap: wall times 12 and 14
    stub["ref"]([
        ([6.0, 12.0], [1e-3, 1e-4], 1e-10),
        ([7.0, 14.0], [1e-3, 1e-4], 1e-10),
    ])
    out = bench.race("x")
    assert out["ref_gap_reached"] is False
    # each wall time is a lower bound on time-to-gap; the max is the
    # tightest honest statement
    assert out["ref_s"] == pytest.approx(14.0)
    assert [a["crossed"] for a in out["ref_attempts"]] == [False, False]


def test_mixed_reference_attempts_score_only_the_crossing_one(stub):
    stub["ours"]([
        _ours_attempt(0.5, [1.0], [1e-9], 1e-10),
        _ours_attempt(0.5, [1.0], [1e-9], 1e-10),
    ])
    # attempt 1 never crosses but stops early (t=5); attempt 2 crosses
    # at t=9 — min over raw times would wrongly report 5
    stub["ref"]([
        ([5.0], [1e-4], 1e-10),
        ([4.0, 9.0], [1e-4, 1e-9], 1e-10),
    ])
    out = bench.race("x")
    assert out["ref_gap_reached"] is True
    assert out["ref_s"] == pytest.approx(9.0)


def test_ours_not_crossing_is_reported_not_scored(stub):
    stub["ours"]([
        _ours_attempt(0.5, [1.0], [1e-7], 1e-10),  # floor above gap
        _ours_attempt(0.5, [1.0], [1e-7], 1e-10),
    ])
    stub["ref"]([
        ([1.0, 3.0], [1e-4, 1e-9], 1e-10),
        ([1.0, 3.0], [1e-4, 1e-9], 1e-10),
    ])
    out = bench.race("x")
    assert out["ours_gap_reached"] is False
    assert out["ours_s"] is None
    assert out["ours_attempts_s"] == [None, None]
    assert "speedup" not in out
