"""Hand-written Hopper (sm_90a) kernels for the port's hot spots.

Each kernel subpackage ships:
  csrc/<name>.cu - the CUDA C++ kernel with a plain C interface
  ops.py         - the wrapper: checks, launch, launch count, autograd
  ref.py         - the plain PyTorch version (CPU path, and the yardstick
                   the kernel is held to on the card)

``_build.py`` compiles the sources with nvcc at first use.
"""
