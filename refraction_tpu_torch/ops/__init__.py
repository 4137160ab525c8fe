"""Plain PyTorch math ops (shading, brute-force intersection, backends)."""
