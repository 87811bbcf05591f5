"""Per-op functions of the port: plain PyTorch versions beside the kernel wrappers."""
