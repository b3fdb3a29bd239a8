"""horopose_tpu_torch: the PyTorch/CUDA port of horopose_tpu.

The JAX package `horopose_tpu` stays the reference. This package imports
torch and numpy only, never JAX or anything of `horopose_tpu`; what it needs
from there it keeps as its own copy. Entry points take an explicit device
("cuda" by default). On a CUDA tensor the soft-argmax goes through the
hand-written kernel in `csrc/soft_argmax.cu`; on a CPU tensor through its
plain PyTorch version.
"""
