"""Local kernels: host CSR/ELL (`sparse`) and the coded-DIA CUDA kernels
with their plain PyTorch versions (`dia`)."""
from .sparse import ELLMatrix, CSRMatrix, compresscoo, csr_block, csr_spmv, indextype, nz_triplets, nziterator, nzindex

__all__ = ["CSRMatrix", "ELLMatrix", "compresscoo", "csr_block", "csr_spmv", "indextype", "nz_triplets", "nziterator",
           "nzindex"]
