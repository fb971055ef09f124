"""Plain PyTorch and NumPy reference of what the benchmark times. It
imports nothing of the program under test."""
