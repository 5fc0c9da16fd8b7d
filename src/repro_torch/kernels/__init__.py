"""Hand-written CUDA kernels of the port, one package per TPU kernel.

``rotseq`` replaces ``repro.kernels.rotseq`` (Pallas wavefront) and
``rotseq_mxu`` replaces ``repro.kernels.rotseq_mxu`` (Pallas MXU).  Each
has ``kernel.py`` (the ``ctypes`` wrapper with its launch counter),
``ref.py`` (the plain PyTorch version) and ``ops.py`` (the host band
loop).  ``_build`` compiles ``csrc/*.cu`` at first use.
"""
