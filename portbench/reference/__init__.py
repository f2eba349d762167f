"""The benchmark's plain reference: plain PyTorch and NumPy, written from
riptide's published semantics. It imports nothing of the program."""
