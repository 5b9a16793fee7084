"""agc-tpu: a JAX-accelerated assembled-genomes collection compressor.

A from-scratch reimplementation of the capabilities of refresh-bio/agc
(reference: v3.2.2, archive format 3.0), redesigned for an
accelerator: the hot compute stages (k-mer scanning, splitter discovery,
segment matching/estimation) run as batched JAX/XLA kernels; the archive
container, metadata and IO layers are host-side.

Public API (parity with reference src/lib-cxx/agc-api.h):
    AGCFile  -- random access decompression of .agc archives.
"""

# allocator tuning first: large-buffer arena retention (see
# utils/allocator.py for the measured why; AGC_TPU_MALLOC_TUNE=0 opts out)
from .utils.allocator import tune_allocator as _tune_allocator

_tune_allocator()

from .version import (
    AGC_FILE_MAJOR,
    AGC_FILE_MINOR,
    PRODUCER,
    PRODUCER_VERSION,
)
from .api import AGCFile

__all__ = [
    "AGCFile",
    "AGC_FILE_MAJOR",
    "AGC_FILE_MINOR",
    "PRODUCER",
    "PRODUCER_VERSION",
]
