"""ngstpu_torch — the ngstpu pipeline ported to PyTorch and CUDA (Hopper).

A second package beside ``ngstpu``: it imports ``torch`` and never ``jax``.
It reuses ngstpu's jax-free host runtime (the C++ ``ngsio`` library, the
FASTQ/gzip readers, the buffer pool, the ring and clone writers) and
replaces the device half:

- ``ngstpu_torch.kernels`` hand-written CUDA kernels for sm_90a, built from
                           ``csrc/`` with nvcc on first use, each beside its
                           plain PyTorch version.
- ``ngstpu_torch.ops``     QC histogram accumulation, the stable sort/dedup
                           engine with its key packers, and the 2-bit codec
                           on torch tensors.
- ``ngstpu_torch.tools``   ``pipeline``, ``fastq_count``, the sort-engine
                           tools and the 2-bit codec tools
                           (``python -m ngstpu_torch.tools.cli <tool>``).
- ``ngstpu_torch.utils``   explicit device selection and the link probe.
"""

__version__ = "0.1.0"
