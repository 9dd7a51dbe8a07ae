"""The benchmark's plain reference of the sfq format (NumPy only; it
imports nothing of the program)."""
