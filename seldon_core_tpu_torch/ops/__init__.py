"""Attention ops: naive and blockwise attention in plain PyTorch
(``attention``), and the hand-written CUDA flash-attention kernel with its
plain version (``flash_attention``)."""
