"""The process-group backend across real process boundaries: two processes
over gloo on the CPU, one shard each (the port's counterpart of
tests/test_multiprocess.py). Both ranks must agree, and equal the
in-process two-shard result. The children import neither jax nor ngstpu."""

import pathlib
import socket
import subprocess
import sys

import numpy as np
import torch

from ngstpu_torch.parallel import dist, dsort, mesh

REPO = pathlib.Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")

_HEAD = r"""
import datetime, sys


class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "ngstpu"):
            raise ImportError(f"{name} is blocked")
        return None


sys.meta_path.insert(0, _Block())
rank, port, repo, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
sys.path.insert(0, repo)
import numpy as np
import torch.distributed as tdist

tdist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                         rank=rank, world_size=2,
                         timeout=datetime.timedelta(seconds=60))
"""
_TAIL = r"""
tdist.destroy_process_group()
print("OK")
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_pair(tmp_path, body: str) -> list[np.ndarray]:
    """Two ranks of `body`; each saves its result as out/r{rank}.npy."""
    child = tmp_path / "child.py"
    child.write_text(_HEAD + body + _TAIL)
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, str(child), str(r), port, str(REPO), str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE) for r in range(2)]
    try:
        for p in procs:
            out, err = p.communicate(timeout=180)
            assert p.returncode == 0, err.decode()[-2000:]
            assert b"OK" in out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [np.load(tmp_path / f"r{r}.npy") for r in range(2)]


def _dedup_input():
    rng = np.random.default_rng(5)
    B, W = 1001, 3
    words = (rng.integers(0, 16, (B, W)) * 0x10001001).astype(np.uint32)
    lens = rng.integers(8, 12, B).astype(np.int32)
    sumq = rng.integers(0, 900, B).astype(np.uint32)
    return words, lens, sumq


def _flat_dedup(res) -> np.ndarray:
    keys, klens, counts, rep = res
    return np.concatenate([keys.reshape(-1).astype(np.int64),
                           klens.astype(np.int64), counts, rep])


def _qc_input():
    rng = np.random.default_rng(6)
    B, L = 64, 32
    seq = np.frombuffer(b"ACGTNacg", np.uint8)[rng.integers(0, 8, (B, L))]
    qual = rng.integers(33, 140, (B, L)).astype(np.uint8)
    lens = rng.integers(0, L + 3, B).astype(np.int32)
    return np.ascontiguousarray(seq), qual, lens, np.array([30, 32])


def test_two_process_allreduce(tmp_path):
    """allreduce_stats, assign_shards and the psum of sharded_qc_step
    (all_reduce) over the group."""
    r0, r1 = _run_pair(tmp_path, r"""
from ngstpu_torch.parallel import dist, mesh, multihost
from tests.test_torch_multiprocess import _qc_input

assert multihost.process_info() == (rank, 2)
got = multihost.allreduce_stats({"q": np.full((3, 4), rank + 1, np.int64),
                                 "f": np.full(2, 0.5 * rank)})
assert (got["q"] == 3).all() and got["q"].dtype == np.int64
assert (got["f"] == 0.5).all()
paths = [f"/nonexistent/f{i}" for i in range(5)]
mine = multihost.assign_shards(paths)
other = multihost.assign_shards(paths, rank=1 - rank, world=2)
assert not set(mine) & set(other) and sorted(mine + other) == sorted(paths)
m = mesh.make_mesh()
assert m.group is not None and m.shards == (rank,) and m.shape == (2,)
# a process-group collective runs over the whole group, never a sub-axis
import torch
from ngstpu_torch.parallel import collectives

try:
    collectives.of(mesh.make_mesh(coord=2)).psum([torch.zeros(1)], "dp")
except ValueError:
    pass
else:
    raise AssertionError("a sub-axis psum over a process group ran")
seq, qual, lens, n_valid = _qc_input()
merged, gc, packed = dist.sharded_qc_step(m)(
    *dist.shard_batch_arrays(m, seq, qual, lens), n_valid)
np.save(f"{out}/r{rank}.npy", np.concatenate(
    [merged[k].reshape(-1).numpy() for k in sorted(merged)]))
""")
    m = mesh.make_mesh(2, devices=[CPU] * 2)
    seq, qual, lens, n_valid = _qc_input()
    merged, _, _ = dist.sharded_qc_step(m)(
        *dist.shard_batch_arrays(m, seq, qual, lens), n_valid)
    single = np.concatenate([merged[k].reshape(-1).numpy()
                             for k in sorted(merged)])
    assert np.array_equal(r0, r1) and np.array_equal(r0, single)


def test_two_process_distributed_dedup(tmp_path):
    """The hash-bucket all_to_all dedup over two processes."""
    r0, r1 = _run_pair(tmp_path, r"""
from ngstpu_torch.parallel import dsort, mesh
from tests.test_torch_multiprocess import _dedup_input, _flat_dedup

res = dsort.distributed_dedup(mesh.make_mesh(2), *_dedup_input())
np.save(f"{out}/r{rank}.npy", _flat_dedup(res))
""")
    single = _flat_dedup(dsort.distributed_dedup(
        mesh.make_mesh(2, devices=[CPU] * 2), *_dedup_input()))
    assert np.array_equal(r0, r1) and np.array_equal(r0, single)


def test_two_process_distributed_sort(tmp_path):
    """The sample sort (all_gather'd splitters, all_to_all) over two
    processes."""
    r0, r1 = _run_pair(tmp_path, r"""
from ngstpu_torch.parallel import dsort, mesh
from tests.test_torch_multiprocess import _dedup_input

words, lens, _ = _dedup_input()
np.save(f"{out}/r{rank}.npy", dsort.distributed_sort(mesh.make_mesh(2),
                                                     words, lens))
""")
    words, lens, _ = _dedup_input()
    single = dsort.distributed_sort(mesh.make_mesh(2, devices=[CPU] * 2),
                                    words, lens)
    assert np.array_equal(r0, r1) and np.array_equal(r0, single)
