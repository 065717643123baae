"""Local kernels: host CSR/ELL (`sparse`) and the coded-DIA CUDA kernels
with their plain PyTorch versions (`dia`)."""
