"""The port's request spans and copy counter (ngstpu_torch/utils/timing.py)
on the CPU: the tree a fastqc call through the warm server's request path
leaves, the same spans in a torch.profiler trace, nothing while spans are
off, the h2d_bytes counter, and the benchmark's six readers of them."""

import collections
import importlib.util
import json
import pathlib
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ngsbench.trace import Trace
from ngstpu_torch.testing.fixtures import illumina_fastq_pair_fast
from ngstpu_torch.tools.server import _run_tool
from ngstpu_torch.utils import timing
from ngstpu_torch.utils.device import upload

REPO = pathlib.Path(__file__).resolve().parent.parent
STAGES = ["parse", "placement", "tile_names1", "modules1", "render1",
          "tile_names2", "modules2", "render2", "dedup", "dup_render"]
CHARTS = ["q20q30", "quality_heatmap", "nucleotide", "gc_density",
          "boxplotquality", "length", "adapter"]
RENDER = ["render.tsv"] + [f"render.png.{c}" for c in CHARTS]
MODULES = ["modules.upload", "modules.stats", "modules.adapter",
           "modules.tiles", "modules.kmer"]
SUBSPANS = {"parse": ["parse.read1", "parse.read2"], "placement": [],
            "tile_names1": [], "tile_names2": [], "modules1": MODULES,
            "modules2": MODULES, "render1": RENDER, "render2": RENDER,
            "dedup": ["dedup.key", "dedup.pack", "dedup.groups"],
            "dup_render": ["render.tsv", "render.png.duplication",
                           "dup.overrepresented"]}


# How far a span's bounds may lie from its profiler range. Between the
# span's clock read and the profiler's own the host may switch threads:
# on an 8-core CPU host under this suite's own parallel run, the farthest
# of 60 calls x 92 bounds lay 0.13 ms out, and one bound 3.4 ms out was
# seen once; 7 copies of one call on 8 cores set bounds 12-24 ms out
# (whole 4 ms scheduler ticks). A span read on another clock lies
# seconds out.
SLACK_US = 5000


@pytest.fixture
def pair(tmp_path):
    a, b = illumina_fastq_pair_fast(600, 90, seed=12, min_len=40,
                                    dup_frac=0.3)
    (tmp_path / "a.fq").write_bytes(a)
    (tmp_path / "b.fq").write_bytes(b)
    return tmp_path


@pytest.fixture
def record(monkeypatch):
    """An empty request record of the test's own, spans' triggers unset,
    the device placement (on CPU tensors)."""
    monkeypatch.setattr(timing, "_RECORD", collections.deque(maxlen=4096))
    monkeypatch.delenv("NGSTPU_STAGE_JSON", raising=False)
    monkeypatch.delenv("NGSTPU_TRACE", raising=False)
    monkeypatch.setenv("NGSTPU_LINK", "device")
    return timing._RECORD


def _fastqc(d, out="r"):
    rc, _, err = _run_tool("fastqc", [str(d / out), str(d / "a.fq"),
                                      str(d / "b.fq")], str(d),
                           torch.device("cpu"))
    assert rc == 0, err


def test_request_record(pair, record, monkeypatch):
    """One record, one call id; server.request -> tool.fastqc -> the ten
    stages, contiguous and in order, each sub-span inside its stage; the
    stage JSON line's flat keys as before, with the call id and spans."""
    monkeypatch.setenv("NGSTPU_STAGE_JSON", str(pair / "stages.json"))
    _fastqc(pair)
    assert len(record) == 1
    rec = record[0]
    assert rec["tool"] == "fastqc" and rec["rc"] == 0
    assert set(rec["counts"]) == {"h2d_bytes", "tile_rows_native",
                                  "tile_rows_loop"}
    # every read of both 600-read mates is sampled, the native pass reads
    # all their tiles
    assert rec["counts"]["tile_rows_native"] == 1200
    assert rec["counts"]["tile_rows_loop"] == 0
    spans = rec["spans"]
    assert [s[0] for s in spans] == sorted({s[0] for s in spans})
    by_id = {s[0]: s for s in spans}
    root, tool = spans[0], spans[1]
    assert root[1:3] == (None, "server.request")
    assert tool[1:3] == (root[0], "tool.fastqc")
    assert root[3] <= tool[3] and tool[4] <= root[4]
    stages = [s for s in spans if s[1] == tool[0]]
    assert [s[2] for s in stages] == STAGES
    assert tool[3] <= stages[0][3] and stages[-1][4] <= tool[4]
    for prev, nxt in zip(stages, stages[1:]):
        assert prev[4] == nxt[3]
    for st in stages:
        subs = [s for s in spans if s[1] == st[0]]
        assert [s[2] for s in subs] == SUBSPANS[st[2]]
        for s in subs:
            assert st[3] <= s[3] <= s[4] <= st[4], (st, s)
            assert not any(x[1] == s[0] for x in spans)
    assert all(by_id[s[1]] for s in spans[1:])
    assert all(s[5] >= 0 and s[6] >= 0 for s in spans)

    line = json.loads((pair / "stages.json").read_text().splitlines()[-1])
    assert [k for k, v in line.items() if isinstance(v, dict)] == STAGES
    for k in STAGES:
        assert set(line[k]) == {"wall_s", "usr_s", "sys_s"}
    assert line["verdict"] == "device"
    assert line["call_id"] == rec["call_id"]
    # the tool writes its line inside server.request, which is still open
    assert line["spans"] == [list(s) for s in spans[1:]]


def test_profiler_trace_holds_the_spans(pair, record, tmp_path):
    """Under a CPU torch.profiler every span is a user_annotation of its
    name, and, by the call annotation's offset, its bounds are the
    in-process ones within SLACK_US."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm-up"):
            pass
        with record_function("ngsbench.call.0"):
            c0 = time.monotonic()
            _fastqc(pair)
    trace = tmp_path / "trace.json"
    prof.export_chrome_trace(str(trace))
    by_name = collections.defaultdict(list)
    for e in json.loads(trace.read_text())["traceEvents"]:
        if e.get("cat") == "user_annotation":
            by_name[e["name"]].append((e["ts"], e["ts"] + e["dur"]))
    off = by_name.pop("ngsbench.call.0")[0][0] - c0 * 1e6
    spans = record[0]["spans"]
    assert len(spans) == 46
    missed = []
    for name in {s[2] for s in spans}:
        mine = sorted((s[3] / 1e3 + off, s[4] / 1e3 + off)
                      for s in spans if s[2] == name)
        theirs = sorted(by_name[name])
        assert len(theirs) == len(mine), name
        for k, ((a0, a1), (b0, b1)) in enumerate(zip(mine, theirs)):
            if abs(a0 - b0) >= SLACK_US or abs(a1 - b1) >= SLACK_US:
                missed.append((name, k, round(a0 - b0), round(a1 - b1)))
    assert not missed


@pytest.mark.parametrize("trace_env", [False, True])
def test_spans_off(pair, record, monkeypatch, trace_env):
    """No trigger: nothing recorded, no stage file, and span() hands out
    one shared no-op context. NGSTPU_TRACE in a server's environment is
    none: it profiles only a local CLI run, and a served call records no
    spans that nothing would read."""
    if trace_env:
        monkeypatch.setenv("NGSTPU_TRACE", str(pair / "traces"))
    _fastqc(pair)
    assert len(record) == 0 and timing._OPEN is None
    assert list(pair.glob("*.json")) == []
    assert not (pair / "traces").exists()
    assert timing.span("a") is timing.span("b")
    assert timing.request("a", "t") is timing.span("c")


@pytest.mark.parametrize("shape,dtype", [((7,), np.int64),
                                         ((33, 5), np.uint8),
                                         ((4, 6), np.int32)])
def test_upload_counts_h2d_bytes(shape, dtype):
    """h2d_bytes grows by the bytes each upload moves to a device that is
    not the CPU (`meta` needs no card); a CPU target is not counted."""
    a = np.arange(int(np.prod(shape)), dtype=dtype).reshape(shape)
    moved = [a, a[:, ::-1] if a.ndim == 2 else a[::2], a.T]
    before = timing.COUNTS["h2d_bytes"]
    outs = [upload(m, torch.device("meta")) for m in moved]
    assert all(o.device.type == "meta" for o in outs)
    assert timing.COUNTS["h2d_bytes"] - before == sum(m.nbytes
                                                      for m in moved)
    before = timing.COUNTS["h2d_bytes"]
    got = upload(moved[1], torch.device("cpu"))
    assert timing.COUNTS["h2d_bytes"] == before
    assert np.array_equal(got.numpy(), moved[1])


# --- the benchmark's readers (ngsbench/metrics) on a hand-made window

def _reader(name):
    path = REPO / "ngsbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"m_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rec(call_id, at_s, tool_ms, key_ms, h2d):
    """A request at `at_s` s: server.request 10-90 ms, tool.fastqc from
    `tool_ms` to 88 ms, render1 12-50 (a 10 ms q20q30 chart, then TSVs),
    dedup 50-88 (key for `key_ms`, groups to 80 ms)."""
    def ns(ms):
        return int(round((at_s + ms / 1e3) * 1e9))

    k = 50 + key_ms
    return dict(call_id=call_id, tool="fastqc", rc=0,
                counts={"h2d_bytes": h2d},
                spans=[(1, None, "server.request", ns(10), ns(90), 0, 0),
                       (2, 1, "tool.fastqc", ns(tool_ms), ns(88), 0, 0),
                       (3, 2, "render1", ns(12), ns(50), 0, 0),
                       (4, 3, "render.png.q20q30", ns(12), ns(22), 0, 0),
                       (5, 3, "render.tsv", ns(22), ns(50), 0, 0),
                       (6, 2, "dedup", ns(50), ns(88), 0, 0),
                       (7, 6, "dedup.key", ns(50), ns(k), 0, 0),
                       (8, 6, "dedup.groups", ns(k), ns(80), 0, 0)])


@pytest.fixture
def window(tmp_path, monkeypatch):
    """Two calls of 1000 reads at 10.0 and 10.2 s on the host's clock,
    annotated at 1.0 and 1.2 s on the trace's; in each, a kernel for its
    first 12 ms and a 5 ms host-to-device copy at 70 ms."""
    ev = []
    for i, t in enumerate((1_000_000, 1_200_000)):
        ev += [dict(ph="X", cat="user_annotation", name=f"ngsbench.call.{i}",
                    ts=t, dur=100_000),
               dict(ph="X", cat="kernel", name="k", ts=t, dur=12_000),
               dict(ph="X", cat="gpu_memcpy",
                    name="Memcpy HtoD (Pageable -> Device)", ts=t + 70_000,
                    dur=5_000)]
    (tmp_path / "t.json").write_text(json.dumps({"traceEvents": ev}))
    calls = [dict(index=i, start=s, end=s + 0.1, reads=1000)
             for i, s in enumerate((10.0, 10.2))]
    rec = collections.deque([_rec(7, 10.0, 14, 10, 3000),
                             _rec(8, 10.2, 12, 20, 5000)], maxlen=4096)
    monkeypatch.setattr(timing, "_RECORD", rec)
    return SimpleNamespace(calls=calls, trace=Trace(tmp_path / "t.json"))


# idle within the calls: 12-70 and 75-100 ms of each (83 ms); the leaf
# spans cover 12-80 ms, so 80-100 ms of each is idle outside them
READINGS = {"server.dispatch_ms_per_call": ((80 - 74) + (80 - 76)) / 2,
            "fastqc.png_s_per_mreads": 0.020 / 0.002,
            "fastqc.dedup_key_s_per_mreads": 0.030 / 0.002,
            "copies.h2d_bytes_per_read": 8000 / 2000,
            "copies.h2d_gb_per_s": 8000 / 0.010 / 1e9,
            "device.idle_outside_spans_share": 100.0 * 40 / 166}


@pytest.mark.parametrize("name", sorted(READINGS))
def test_reader(name, window, monkeypatch):
    """Each reader's hand-worked value; None once a call has no record,
    and None from a program without the record."""
    read = _reader(name).read
    assert read(window) == pytest.approx(READINGS[name], rel=1e-9)
    timing._RECORD.pop()
    assert read(window) is None
    monkeypatch.delattr(timing, "requests")
    assert read(window) is None
