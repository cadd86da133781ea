"""Plain PyTorch references, one module per configuration, and what they
share (``common.py``). They import nothing of the program."""
