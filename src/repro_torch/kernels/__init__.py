"""The port's kernels: CUDA C++ for the H100 (``sm_90a``), each beside a
plain PyTorch version.

Each kernel package has:
  ref.py — the plain PyTorch version (tests, CPU tables, comparisons)
  ops.py — the wrapper: checks the inputs, launches the CUDA kernel on
           CUDA tensors (or raises), runs ref.py on CPU tensors, and
           counts its launches
The sources are under ``src/repro_torch/csrc``; ``_build.py`` compiles
them with ``nvcc`` at first use and loads them with ``ctypes``.  Call
sites go through ``registry.dispatch``.

Kernels:
  xtx              — X^T X and X^T y of a row block (the OLS transition)
  segment_linregr  — the whole grouped OLS fold over group-aligned blocks
  countmin         — the Count-Min counts of a column (its transition)
  segment_countmin — the whole grouped Count-Min fold
  segment_fm       — the whole grouped Flajolet-Martin fold
  kmeans_assign    — nearest centroid of every row, with the per-centroid
                     sums and counts (the fused k-means transition)
  flash_attention  — causal GQA attention forward with an online softmax
                     (the LM prefill's attention)
The sketches share one hash family: ``sketch_hash.py`` beside
``csrc/sketch_hash.cuh``.
"""
