"""PyTorch/CUDA port of ``lanczosnet_tpu`` for one NVIDIA H100.

The JAX package is the reference; each module here keeps the name of
its JAX counterpart. This package imports neither JAX nor anything of
``lanczosnet_tpu``. Its hand-written kernels live in ``csrc/`` and are
built with ``nvcc`` on first use (``ops/_build.py``).

Ported so far: serving (``serve.Predictor`` and ``serve.MicroBatcher``
in-process; ``serve_http.ModelServer`` behind a stdlib HTTP front or the
native C++ front of ``serve_native``; ``torch.export`` artifacts in
``export``; runs the JAX package trained, read from their flax msgpack
checkpoints), the QM8 trainer for every single-device QM8 config
(``cli``, ``train.runner.QM8Runner``), full-graph citation training
(``train.citation_runner.CitationRunner``) and sparse full-graph
training on one device or sharded over the ranks of a
``torch.distributed`` group (``train.sparse_citation_runner``,
``parallel``), with both Lanczos
tridiagonalization kernels in CUDA (``csrc/lanczos_tridiag.cu`` for
graphs of at most 128 nodes, ``csrc/lanczos_stream.cu`` above) behind
the custom operator ``lanczosnet::lanczos_tridiag_resid``, and the
adjoint backward of the recursion around them. ``ROADMAP.md`` lists
what is next.
"""
