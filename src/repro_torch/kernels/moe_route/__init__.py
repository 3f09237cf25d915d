"""Each MoE slot's place within its expert: CUDA kernel."""
