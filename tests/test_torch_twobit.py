"""The port's 2-bit codec against ngstpu's jitted one, and fastq2twobit /
twoBit2seq (device="cpu") against ngstpu's CLI: exact bytes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngstpu.ops import twobit as jtb
from ngstpu.testing.fixtures import random_fastq
from ngstpu.tools.cli import main as jax_cli
from ngstpu_torch.ops import twobit as tb
from ngstpu_torch.tools import fastq2twobit
from ngstpu_torch.tools.cli import main as torch_cli


def test_codec_matches_jax():
    rng = np.random.default_rng(3)
    # every byte value, lowercase and U/N included, plus zero padding
    seq = rng.integers(0, 256, (300, 64), dtype=np.uint8)
    seq[:, 50:] = 0
    before = dict(tb.CODEC)
    packed = tb.pack2bit(torch.from_numpy(seq))
    np.testing.assert_array_equal(
        tb.base_codes(torch.from_numpy(seq)).numpy(),
        np.asarray(jtb.base_codes(jnp.asarray(seq))))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jtb.pack2bit(jnp.asarray(seq))))
    unpacked = tb.unpack2bit(packed)
    np.testing.assert_array_equal(
        unpacked.numpy(), np.asarray(jtb.unpack2bit(jnp.asarray(packed))))
    for op in ("pack2bit", "unpack2bit"):
        assert tb.CODEC[op, "cpu"] == before.get((op, "cpu"), 0) + 1


@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("flag", ["-s", "-n"])
@pytest.mark.parametrize("on_device", [True, False])
def test_fastq2twobit_and_back(tmp_path, monkeypatch, fast, flag,
                               on_device):
    """Both tools through both CLIs. `on_device` drops the 8 MB floor of
    the port's device codec, so the small input takes the device pack and
    unpack under NGSTPU_LINK=device (ngstpu runs its numpy codec here)."""
    monkeypatch.setenv("NGSTPU_LINK", "device" if on_device else "host")
    if not fast:
        monkeypatch.setenv("NGSTPU_NO_FASTPATH", "1")
    if on_device:
        monkeypatch.setattr(fastq2twobit, "DEVICE_MIN_BYTES", 0)
    p = tmp_path / "in.fq"
    p.write_bytes(random_fastq(300, 90, seed=21, var_len=True,
                               with_n=True))
    suffix = "_sort_by_seq.fq" if flag == "-s" else "_sort_by_name.fq"
    before = dict(tb.CODEC)
    got = {}
    for side, cli, pre in (("jax", jax_cli, []),
                           ("torch", torch_cli, ["--device", "cpu"])):
        o = tmp_path / side
        assert cli([*pre, "fastq2twobit", "-i", str(p), flag, "-o",
                    str(o)]) == 0
        assert cli([*pre, "twoBit2seq", "-i", f"{o}{suffix}", "-o",
                    str(o)]) == 0
        got[side] = ((tmp_path / f"{side}{suffix}").read_bytes(),
                     (tmp_path / f"{side}.decompress").read_bytes())
    assert got["jax"] == got["torch"]
    assert len(got["torch"][1]) > 300
    packs = tb.CODEC["pack2bit", "cpu"] - before.get(("pack2bit", "cpu"), 0)
    unpacks = (tb.CODEC["unpack2bit", "cpu"]
               - before.get(("unpack2bit", "cpu"), 0))
    assert (packs, unpacks) == ((int(on_device and not fast), int(on_device)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_codec_on_card(cuda):
    rng = np.random.default_rng(4)
    seq = torch.from_numpy(rng.integers(0, 256, (100000, 100),
                                        dtype=np.uint8))
    packed = tb.pack2bit(seq.to(cuda))
    assert torch.equal(packed.cpu(), tb.pack2bit(seq))
    assert torch.equal(tb.unpack2bit(packed).cpu(),
                       tb.unpack2bit(packed.cpu()))
