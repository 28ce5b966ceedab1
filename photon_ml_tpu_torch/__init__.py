"""PyTorch/CUDA port of ``photon_ml_tpu``.

Module names follow the JAX package so each function has an obvious
counterpart there (``types``, ``ops.losses``, ``optimize.lbfgs_margin``,
``parallel.data_parallel``, ...). The port imports neither ``jax`` nor
``photon_ml_tpu``. Entry points place data on ``cuda`` unless the caller
passes ``device="cpu"``; the one hand-written CUDA kernel
(``ops.kernels.multiply_prefix_sum``) launches on CUDA tensors and takes
its plain PyTorch version on CPU tensors. ``native/`` holds host-side C++
libraries (the Avro decoder and the feature index store), built with
``g++`` at first use; they are not device kernels.
"""
