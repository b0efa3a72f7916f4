"""tools/trace_tick.py's reduction from trace events to per-tick metrics."""

from __future__ import annotations

import importlib.util
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tt():
    spec = importlib.util.spec_from_file_location(
        "trace_tick", os.path.join(ROOT, "tools", "trace_tick.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("events,units,busy_ns,window_ns,kernels,copies", [
    # One op: busy == window, no idle.
    ([("fusion", 0, 10)], 1, 10, 10, 1, 0),
    # A gap of 10 ns between two ops.
    ([("a", 0, 10), ("b", 20, 10)], 2, 20, 30, 2, 0),
    # Overlapping ops on two streams count once; a copy is busy time but
    # not a kernel.
    ([("a", 0, 10), ("Memcpy DtoH", 5, 10), ("b", 30, 5)], 1, 20, 35, 2, 1),
    # Unsorted input, one op nested inside another.
    ([("b", 50, 10), ("a", 0, 40), ("c", 10, 5)], 2, 50, 60, 3, 0),
])
def test_reduce_events(tt, events, units, busy_ns, window_ns, kernels,
                       copies):
    r = tt.reduce_events(events, units)
    assert r["units"] == units
    assert r["kernels_per_unit"] == kernels / units
    assert r["copies_per_unit"] == copies / units
    assert r["device_busy_us_per_unit"] == pytest.approx(
        busy_ns / units / 1e3)
    assert r["device_window_us"] == pytest.approx(window_ns / 1e3)
    assert r["idle_share"] == pytest.approx(1 - busy_ns / window_ns)


def test_kernel_table_orders_by_time(tt):
    events = [("a", 0, 5), ("b", 5, 30), ("a", 40, 5), ("c", 50, 1)]
    rows = tt.kernel_table(events, units=2, top=2)
    assert [r["name"] for r in rows] == ["b", "a"]
    assert rows[1] == {"name": "a", "calls_per_unit": 1.0,
                       "us_per_unit": 5 / 1e3}
