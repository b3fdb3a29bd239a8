"""The plain reference: the flagship FullNet, its FK, serving and train
step in plain PyTorch, importing nothing of the program."""
