"""PyTorch/CUDA port of diffusion_image_editing_tpu for NVIDIA Hopper GPUs."""
