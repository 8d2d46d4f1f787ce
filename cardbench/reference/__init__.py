"""Plain references, in plain PyTorch: nothing of the measured program."""
