"""Model configurations (EfficientViT-B1)."""
