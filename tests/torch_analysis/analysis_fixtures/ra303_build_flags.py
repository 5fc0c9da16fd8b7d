# repro-torch-lint: fixture-as=src/repro_torch/kernels/_build.py
"""RA303 fixture: the kernels built without --fmad=false."""
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",  # expect: RA303
         "-shared", "-Xcompiler", "-fPIC"]
