"""The port's link probe (ngstpu_torch/utils/linkprobe.py): only a measured
bandwidth under NGSTPU_QC_BW_MIN may send work to the host. A probe whose
child fails raises, and leaves no verdict in memory or in the cache."""

import numpy as np
import pytest

from ngstpu_torch.ops.count import QCAccumulator
from ngstpu_torch.utils import linkprobe as lp

BIG = np.zeros(8 << 20, np.uint8)


@pytest.fixture
def fresh(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))
    for name in ("NGSTPU_LINK", "NGSTPU_QC", "NGSTPU_QC_BW_MIN",
                 "NGSTPU_LINK_TTL"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(lp, "_VERDICT", [])
    monkeypatch.setattr(lp, "LAST_PROBE", {})
    return lp


@pytest.mark.parametrize("child,msg", [
    ("import sys; sys.stderr.write('no card here'); sys.exit(3)",
     "no card here"),
    ("print('not a number')", "could not convert"),
    ("print('')", "0 times for 2 copies"),
    ("print(1e-6)", "stopped after a fast copy"),
])
def test_failed_probe_raises_and_stores_nothing(fresh, monkeypatch, child,
                                                msg):
    monkeypatch.setattr(lp, "_probe_code", lambda dev, sizes, bw: child)
    with pytest.raises(RuntimeError, match=msg):
        lp.probe_link(BIG)
    assert lp.link_verdict() is None
    assert not lp._cache_path().exists()
    # the QC accumulator's auto placement raises too: it never counts on
    # the host behind a failed probe
    acc = QCAccumulator("cpu")
    qual = np.full((1 << 16, 128), 40, np.uint8)
    with pytest.raises(RuntimeError, match=msg):
        acc.add_batch(qual, np.full(1 << 16, 128, np.int32))
    assert lp.link_verdict() is None


def test_measured_slow_link_gives_host_and_is_cached(fresh, monkeypatch):
    # the child times the 1MB copy at 1 MB/s and stops there
    monkeypatch.setattr(lp, "_probe_code",
                        lambda dev, sizes, bw: "print(1.048576)")
    assert lp.probe_link(BIG) == "host"
    probe = dict(lp.LAST_PROBE)
    assert probe.pop("wall") > 0
    assert probe == dict(verdict="host", cached=False, nbytes=1 << 20,
                         seconds=1.048576)

    def boom(*a, **k):
        raise AssertionError("the cached verdict must be served")

    monkeypatch.setattr(lp, "_timed_puts", boom)
    monkeypatch.setattr(lp, "_VERDICT", [])
    assert lp.probe_link(BIG) == "host"
    assert lp.LAST_PROBE["cached"] is True


@pytest.mark.parametrize("times,verdict", [
    ([1e-4, 4e-4], "device"),  # 10 and 21 GB/s
    ([1e-4, 0.1], "host"),  # the 8MB copy confirms a slow link
])
def test_staged_verdict(fresh, monkeypatch, times, verdict):
    calls = []

    def puts(sizes, deadline):
        calls.append(sizes)
        return times

    monkeypatch.setattr(lp, "_timed_puts", puts)
    assert lp.probe_link(BIG) == verdict
    assert calls == [(1 << 20, 8 << 20)]
    assert lp.LAST_PROBE["nbytes"] == 8 << 20
    assert lp.link_verdict() == verdict
    assert lp._cached_verdict() == verdict


def test_small_operands_and_overrides_skip_the_probe(fresh, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("no probe expected")

    monkeypatch.setattr(lp, "_timed_puts", boom)
    assert lp.probe_link(np.zeros(1 << 20, np.uint8)) == "device"
    assert lp.link_verdict() is None
    monkeypatch.setenv("NGSTPU_LINK", "host")
    assert lp.probe_link(BIG) == "host"


def test_real_child_times_both_copies(fresh):
    times = lp._timed_puts((1 << 20, 2 << 20), deadline=10.0)
    assert len(times) == 2 and all(0 < t < 30.0 for t in times)
