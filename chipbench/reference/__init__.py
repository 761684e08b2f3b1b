"""Plain NumPy reference for the benchmark's answers.  It imports nothing of
the program under test, nor JAX, nor the JAX package."""
