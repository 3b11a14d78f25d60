"""PyTorch/CUDA port of ``lanczosnet_tpu`` for one NVIDIA H100.

The JAX package is the reference; each module here keeps the name of
its JAX counterpart. This package imports neither JAX nor anything of
``lanczosnet_tpu``. Its hand-written kernels live in ``csrc/`` and are
built with ``nvcc`` on first use (``ops/_build.py``).

Ported so far: the LanczosNet serving path (``serve.Predictor`` and
``serve.MicroBatcher``), with the Lanczos tridiagonalization as a CUDA
kernel (``csrc/lanczos_tridiag.cu``). ``ROADMAP.md`` lists what is next.
"""
