"""gfla_tpu_torch: the PyTorch and CUDA port of gfla_tpu for NVIDIA Hopper.

Global-Flow-Local-Attention pose-guided person image generation, served and
trained on one H100 from DeepFashion- and Market-layout trees on disk (JPEG
decode and encode on the card through nvJPEG). The module names follow gfla_tpu's, which stays the
reference the port is tested against. Modules are NCHW with channels_last
activations, as in the original GFLA, so its checkpoints load by key;
op-level functions take gfla_tpu's NHWC layout. The local-attention warp and
its backward run as hand-written CUDA kernels (csrc/warp_fwd.cu,
csrc/warp_bwd.cu) built with nvcc at first use.
"""

__version__ = "0.1.0"
