"""Plain NumPy references the output checks compare with."""
