"""Hand-written CUDA kernels of the port, their plain PyTorch versions
(``ref``) and the ``ops`` dispatch facade. Importing this package builds
nothing: a kernel is compiled at its first launch (``_build``)."""
