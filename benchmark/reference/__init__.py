"""The plain reference that decides ``correct``: an f64 residual worked out
from the benchmark's own copy of the matrix. Imports nothing of the program.
"""
