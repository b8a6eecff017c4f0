"""A configuration, a traffic mix, a per-layer metric and a tool reference
dropped in as new files, with new entries in BENCHMARK.json, are found by
name and run, and no file that was there changes."""

from __future__ import annotations

import hashlib
import json
import textwrap

import pytest

NEW_CONFIG = {
    "name": "tiny_miseq_se75", "layout": "SE", "read_len": 75,
    "quality": {"kind": "uniform", "lo": 35, "hi": 70},
    "names": {"prefix": "@M00123:5:000000000-A1B2C:1:",
              "flowcell": {"surfaces": 2, "swaths": 1,
                           "tiles_per_swath": 14}},
    "dup_frac": 0.2, "hot": 2, "n_frac": 0.02, "adapter_frac": 0.01}

COUNT_REF = '''
"""fastq_count's reads and bases per file, from the file alone."""
LIMITS = {"count_fields": 0}

def expected(paths, device="cpu", sample=1):
    out = []
    for p in paths:
        lines = open(p, "rb").read().split(b"\\n")[:-1]
        out.append((len(lines) // 4, sum(len(s) for s in lines[1::4])))
    return out

def compare(exp, prefix):
    rows = [line.split("\\t") for line in
            open(prefix + ".stdout").read().splitlines()]
    got = [(int(r[1]), int(r[2])) for r in rows]
    bad = sum(a != b for a, b in zip(exp, got)) + abs(len(exp) - len(got))
    return {"count_fields": bad}
'''

CALLS_METRIC = '''
def read(ctx):
    return len(ctx.calls) / (ctx.calls[-1]["end"] - ctx.calls[0]["start"])
'''


def digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_new_files_found_by_name(tiny):
    root, run = tiny
    before = digest(root)
    lay = root / "ngsbench"
    (lay / "configs" / "tiny_miseq_se75.json").write_text(
        json.dumps(NEW_CONFIG))
    (lay / "traffic" / "tiny_count.json").write_text(json.dumps(
        {"tool": "fastq_count", "argv": ["{inputs}"], "reads_per_file": 2000,
         "sets": 2}))
    (lay / "metrics" / "calls_per_s.py").write_text(CALLS_METRIC)
    (lay / "refs" / "fastq_count.py").write_text(textwrap.dedent(COUNT_REF))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_miseq_se75", "source": "a test",
                             "file": "ngsbench/configs/tiny_miseq_se75.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"] += [
        {"name": "tiny_count", "config": "tiny_miseq_se75",
         "traffic": "tiny_count", "chips": 1, "why": "a test"},
        {"name": "tiny_miseq_qc", "config": "tiny_miseq_se75",
         "traffic": "tiny_lane", "chips": 1, "why": "a test"}]
    bench["per_layer"].append(
        {"name": "calls_per_s", "unit": "calls/s", "better": "higher",
         "source": "host_clock", "layer": "harness", "moves": "reads_per_s",
         "workloads": ["tiny_count", "tiny_miseq_qc"]})
    idle = next(m for m in bench["per_layer"]
                if m["name"] == "device.idle_share")
    idle["workloads"] += ["tiny_count", "tiny_miseq_qc"]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    after = digest(root)
    assert {k: after[k] for k in before if k.name != "BENCHMARK.json"} == \
        {k: v for k, v in before.items() if k.name != "BENCHMARK.json"}

    r = run("tiny_count", 21)
    assert r["correct"] and r["attempted"] >= 1
    assert r["checks"]["count_fields"] == {"value": 0, "limit": 0}
    assert set(r["metrics"]) == {"reads_per_s", "peak_rss_gib", "setup_s"}
    r = run("tiny_count", 22, trace=True)
    assert r["correct"] and set(r["metrics"]) == {"calls_per_s",
                                                  "device.idle_share"}
    r = run("tiny_miseq_qc", 23, trace=True)
    assert r["correct"] and r["checks"]["per_tile"]["value"] == 0
    # the fastqc metrics list their cells, and this one is not among them
    assert set(r["metrics"]) == {"calls_per_s", "device.idle_share"}


@pytest.mark.parametrize("change", [{"callers": 4}, {"order": "random"},
                                    {"sets": 1}, {"gzip_level": 0},
                                    {"gzip_level": 10}, {"gzip_level": "1"},
                                    {"gzip_level": True}])
def test_mix_asking_for_another_load_is_refused(tiny, change):
    """A mix key the harness does not drive, a single input set (each
    call's answer would equal the previous call's) or a gzip_level that is
    not a whole number from 1 to 9 stops the run before it starts instead
    of being run as something else."""
    from ngsbench import core

    root, _ = tiny
    mix = root / "ngsbench" / "traffic" / "tiny_lane.json"
    mix.write_text(json.dumps({**json.loads(mix.read_text()), **change}))
    with pytest.raises(ValueError, match="tiny_lane"):
        core.Layout(root, root / "ngsbench").cell("tiny_se")
