"""AIR in plain PyTorch, the yardstick that decides ``correct``.

Written apart from the program it judges: it imports neither the program
nor JAX, and takes nothing the program made.  The benchmark makes the
weights, the digit bank and the canvases, and hands the same to both.
"""
