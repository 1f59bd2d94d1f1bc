"""The plain reference: the reference viewer's renderer and viewer steps in
plain PyTorch and NumPy, independent of the program under test."""
