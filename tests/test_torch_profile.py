"""The port's pipeline profiler (ngstpu_torch/tools/profile_pipeline.py) at a
tiny size on the CPU: both routes run, and the busy-time merge of device
intervals counts overlapping spans once."""

import types

import torch

from ngstpu_torch.tools import profile_pipeline as pp


def test_profile_runs_both_routes_on_cpu(tmp_path, capsys):
    out = tmp_path / "out"
    assert pp.main(["--device", "cpu", "--reads", "3000",
                    "--work", str(tmp_path / "work"),
                    "--out", str(out)]) == 0
    text = capsys.readouterr().out
    assert "profile fast route, 3000 reads" in text
    assert "profile generic route, 3000 reads" in text
    assert "trim_write=" in text  # the twin with N took the generic route
    assert sorted(p.name for p in out.iterdir()) == [
        "profile_fast.txt", "profile_generic.txt"]
    assert not (tmp_path / "work").exists()


def test_device_busy_merges_overlaps():
    cuda = torch.autograd.DeviceType.CUDA
    cpu = torch.autograd.DeviceType.CPU

    def ev(name, t0, t1, dev=cuda):
        return types.SimpleNamespace(
            name=name, device_type=dev,
            time_range=types.SimpleNamespace(start=t0, end=t1))

    prof = types.SimpleNamespace(events=lambda: [
        ev("k", 0, 1000), ev("k", 500, 1500), ev("copy", 3000, 3500),
        ev("aten::sort", 0, 9000, cpu)])
    busy, ops = pp.device_ops(prof)
    assert busy == 2.0  # ms: [0, 1500] and [3000, 3500]
    assert ops == {"k": [2.0, 2], "copy": [0.5, 1]}
