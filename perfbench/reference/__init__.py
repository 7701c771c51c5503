"""Plain float32 references of the benchmark's configurations (PyTorch
and NumPy only; nothing of the program)."""
