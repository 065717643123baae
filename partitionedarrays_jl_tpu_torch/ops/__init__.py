"""Local kernels: host CSR/ELL (`sparse`) and the coded-DIA CUDA kernels
with their plain PyTorch versions (`dia`)."""
from .sparse import CSRMatrix, indextype, nz_triplets, nziterator, nzindex

__all__ = ["CSRMatrix", "indextype", "nz_triplets", "nziterator", "nzindex"]
