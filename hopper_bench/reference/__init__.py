"""The benchmark's plain references, which decide ``correct``: plain
PyTorch in float32 with TF32 off, importing nothing of the program."""
