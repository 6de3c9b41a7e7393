"""PyTorch and CUDA port of polymer_chemprop_tpu (wD-MPNN property
prediction), for NVIDIA Hopper GPUs.

The package keeps the JAX package's layout and module names. It imports
torch and numpy, and nothing of JAX or of the JAX package; its CUDA
kernels (``csrc/``, nvcc) and its C++ host featurizer (``native/src/``,
g++) are built at first use. Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
