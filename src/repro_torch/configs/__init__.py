"""Model configurations (EfficientViT-B1 and B2; the dense, MoE and
recurrent LMs; whisper)."""
