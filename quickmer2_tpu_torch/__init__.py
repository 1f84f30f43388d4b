"""quickmer2_tpu_torch — the PyTorch/CUDA port of the k-mer copy-number
engine.

Same phases and on-disk formats as the JAX package beside it, rebuilt
for one NVIDIA H100:

  search  — unique-k-mer dictionary from a reference genome; the
            edit-distance filter's compare chain is the hand-written
            CUDA kernel csrc/hamming_join.cu
  count   — stream sample reads through the fused mono-table count
            kernel csrc/count_mono.cu (unpack → k-mer codec → DJB →
            one 64-B row probe → depth atomicAdd), or another engine
            (csrc/count_flat.cu: the linear probe, the packed table,
            the sort-join codec), or the anchored read pass; resumable
            from a checkpoint
  cohort  — count + est of many samples against one dictionary
  est     — GC-corrected (LOWESS) windowed copy number, on the host

Every entry point takes a `device` argument that defaults to "cuda"
and raises when no card is present; pass device="cpu" to run the plain
PyTorch versions of the kernels instead (the tests do).
"""

__version__ = "0.1.0"
