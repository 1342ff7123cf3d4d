"""The plain reference: brute-force PyTorch, float32 with TF32 off."""
