from .mt19937 import MT19937, glibc_rand_first, sample_indices, x31_hash_batch  # noqa: F401
