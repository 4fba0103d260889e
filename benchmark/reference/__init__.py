"""Plain float32 references in PyTorch and NumPy. They import nothing of
the program: every array they use they work out from the inputs the
harness hands to both sides."""
