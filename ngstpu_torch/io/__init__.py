from .stream import open_input, open_output, open_text_output  # noqa: F401
from .fastq import FastqChunkReader, FastqBatch, read_fastq_batches  # noqa: F401
