"""PyTorch/CUDA port of akka_allreduce_tpu, for one NVIDIA H100 node.

The JAX package (``akka_allreduce_tpu``) is the reference; this package
mirrors its module paths and names so each counterpart is easy to find,
and never imports it or JAX. The port grows slice by slice (ROADMAP.md);
the first slice is the paged serving path — ``python -m
akka_allreduce_tpu_torch.cli serve --paged --paged-attention kernel`` —
whose decode attention runs a hand-written CUDA kernel
(``ops/kernels/csrc/paged_attention.cu``).

Entry points run on ``cuda`` unless the caller asks for the CPU
(``--device cpu`` / ``device="cpu"``); on the CPU every kernel wrapper
runs its plain PyTorch version.
"""
