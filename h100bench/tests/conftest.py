"""Short traced and host-timed phases for the in-process CPU runs (the
spawned ranks of a four-rank rehearsal keep the harness's own counts)."""

import pytest

from h100bench import bench


@pytest.fixture(autouse=True)
def short_phases(monkeypatch):
    monkeypatch.setattr(bench, "HOST_PAIRS", 5)
    monkeypatch.setattr(bench, "TRACE_PAIRS", 3)
