"""Published peaks of one NVIDIA H100 SXM5 80GB, copied from
``src/repro_torch/launch/mesh.py`` at commit 9acff5f (NVIDIA H100 Tensor
Core GPU datasheet, SXM5 column: BF16 Tensor Core 1,979 TFLOP/s with
sparsity, so 989.4e12 dense; GPU memory bandwidth 3.35 TB/s). A card set
below its 700 W limit runs slower; the run prints the card's limit."""
BF16_FLOPS = 989.4e12      # FLOP/s, dense
HBM_BYTES = 3.35e12        # B/s
