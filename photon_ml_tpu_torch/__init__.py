"""PyTorch/CUDA port of ``photon_ml_tpu``.

Module names follow the JAX package so each function has an obvious
counterpart there (``types``, ``ops.losses``, ``optimize.lbfgs_margin``,
``parallel.data_parallel``, ...). The port imports neither ``jax`` nor
``photon_ml_tpu``. Entry points place data on ``cuda`` unless the caller
passes ``device="cpu"``; the hand-written CUDA kernels
(``ops.kernels.csc_column_sums``, the path's ``X^T d``, and
``multiply_prefix_sum``, the TPU kernel's literal counterpart) launch on
CUDA tensors and take their plain PyTorch versions on CPU tensors. ``native/`` holds host-side C++
libraries (the Avro decoder and the feature index store), built with
``g++`` at first use; they are not device kernels.
"""
