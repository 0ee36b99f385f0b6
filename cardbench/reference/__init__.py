"""Plain references that decide `correct`. NumPy and SciPy only: nothing
here imports the program under test, JAX or the JAX package."""
