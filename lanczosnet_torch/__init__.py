"""PyTorch/CUDA port of ``lanczosnet_tpu`` for one NVIDIA H100.

The JAX package is the reference; each module here keeps the name of
its JAX counterpart. This package imports neither JAX nor anything of
``lanczosnet_tpu``. Its hand-written kernels live in ``csrc/`` and are
built with ``nvcc`` on first use (``ops/_build.py``).

Ported so far: the LanczosNet serving path (``serve.Predictor`` and
``serve.MicroBatcher``) and full-graph citation training
(``train.citation_runner.CitationRunner`` with AdaLanczosNet or
LanczosNet, ``task: node``), with both Lanczos tridiagonalization
kernels in CUDA (``csrc/lanczos_tridiag.cu`` for graphs of at most 128
nodes, ``csrc/lanczos_stream.cu`` above) and the adjoint backward of the
recursion around them. ``ROADMAP.md`` lists what is next.
"""
