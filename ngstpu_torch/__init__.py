"""ngstpu_torch — the ngstpu pipeline ported to PyTorch and CUDA (Hopper).

A second package beside ``ngstpu`` that stands alone: it imports ``torch``
and never ``jax``, and nothing of ``ngstpu``. It keeps its own copy of the
host runtime it needs (the C++ ``ngsio`` library, built with g++ into
``native/build/libngsio_torch.so`` at first use; the FASTQ/gzip readers;
the buffer pool; the ring and clone writers; the host sorts) and replaces
the device half:

- ``ngstpu_torch.io``      host I/O: gzip/FASTQ chunk decoding and the
                           offset index over the native library; the
                           BGZF, BAM and BAI readers and writers.
- ``ngstpu_torch.kernels`` hand-written CUDA kernels for sm_90a, built from
                           ``csrc/`` with nvcc at first use, each beside its
                           plain PyTorch version.
- ``ngstpu_torch.ops``     QC histogram accumulation, the stable sort/dedup
                           engine with its key packers, the 2-bit codec and
                           the fastqc modules and the pileup sweep on
                           torch tensors; the host sorts, packers, codecs
                           and CIGAR walks.
- ``ngstpu_torch.rng``     bit-exact RNG parity (GSL MT19937, glibc rand,
                           X31) for ``gzfastq_sample``.
- ``ngstpu_torch.tools``   every FASTQ and BAM tool of ngstpu's CLI
                           (``python -m ngstpu_torch.tools.cli <tool>``).
- ``ngstpu_torch.utils``   device selection, the link probe, the buffer
                           pool, stage timers, PNG writing.
"""

__version__ = "0.1.0"

from .utils.malloctune import tune_malloc as _tune_malloc

_tune_malloc()  # see utils/malloctune.py: the host's page-fault behaviour
del _tune_malloc
