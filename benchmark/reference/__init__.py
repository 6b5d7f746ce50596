"""The plain reference: the models' mathematics in plain PyTorch and NumPy,
written from the architecture's description, importing nothing of the
program."""
