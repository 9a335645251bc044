"""PyTorch/CUDA port of cuahn_vio for NVIDIA Hopper (H100).

The JAX package ``cuahn_vio`` is the reference; this package imports
nothing of it, nor JAX. Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``. The homography warp and the texture sampler run
through hand-written CUDA kernels (``ops/cuda/warp.cu``), the undistortion
remap of raw camera frames through another (``ops/cuda/remap.cu``), and
the JAX random stream (threefry2x32: MC-dropout masks, sensor noise, the
trainers' draws, Flax's initial kernels) through a third
(``ops/cuda/prng.cu``), on the card, and through their plain PyTorch
versions on the CPU.
"""
