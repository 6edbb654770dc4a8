"""The plain reference that decides a run's ``correct``: float32 PyTorch
with TF32 off, written from the published descriptions, importing
nothing of the program (``repro_torch``) and nothing of JAX. It makes
its own weights from the seed (``perfbench.weights``) and reads only the
program's outputs, to judge them."""
