"""Hand-written CUDA kernels of the port, one package per TPU kernel.

``rotseq`` replaces ``repro.kernels.rotseq`` (Pallas wavefront),
``rotseq_mxu`` replaces ``repro.kernels.rotseq_mxu`` (Pallas MXU) and
``rotseq_batched`` replaces ``repro.kernels.rotseq_batched`` (the fused
multi-request kernel of the serving path).  Each has ``kernel.py`` (the
``ctypes`` wrapper with its launch counter), ``ref.py`` (the plain
PyTorch version) and ``ops.py`` (packing and the host loop).  ``_build``
compiles ``csrc/*.cu`` at first use.
"""
