"""PyTorch/CUDA port of lcgan_tpu for NVIDIA Hopper GPUs."""
