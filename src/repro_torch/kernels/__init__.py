"""The three TCEC kernels (CUDA C++ for Hopper, ``csrc/``), their plain
PyTorch versions, the GEMM oracle and the dispatcher.

  * ``ops.tcec_matmul`` — kernel 1 (``tcec_matmul``), the split GEMM;
  * ``tcec_attention.tcec_attention`` — kernel 2, prefill flash attention;
  * ``tcec_paged_attention.tcec_paged_attention`` — kernel 3, paged decode;
  * ``dispatch`` — routes the models' contractions to them.

Each kernel module keeps a ``launches`` counter of its CUDA launches.
"""
