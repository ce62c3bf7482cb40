"""The plain reference: plain PyTorch, importing nothing of the program."""
