"""Plain references (NumPy, SciPy) that judge the program's answers; a
configuration names its own in ``reference``."""
